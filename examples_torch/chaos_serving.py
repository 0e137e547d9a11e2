"""Chaos serving demo: the TPFIFO game engine absorbing injected faults, on
the port.

The torch twin of ``examples/chaos_serving.py``: a mixed Hex + Gomoku
request batch is served twice, once clean and once under a seeded
``FaultPlan`` (dispatch errors, NaN root-stat poisoning, clock stalls,
duplicate submissions), and shows the resilience machinery at work: failed
quanta retried from committed host snapshots with exponential backoff,
repeatedly failing slots quarantined while the survivors keep serving,
corrupted answers caught by the result guard, and every recovered result
bit-identical to the clean run (asserted). Serving the chaos run builds the
kernel library no more (asserted: the port's counterpart of the JAX
example's jit-cache check). The same behaviour from the command line:

    python -m repro_torch.launch.serve --mcts-game mixed --scheduler tpfifo \\
        --chaos-rate 0.2 --chaos-seed 7 --quarantine-after 3 --max-queue 16

Run me:  python examples_torch/chaos_serving.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from repro_torch.obsv.trace import kernel_builds  # noqa: E402
from repro_torch.serve.games import GameRequest, TPFIFOGameEngine  # noqa: E402
from repro_torch.serve.resilience import FaultInjector, FaultPlan  # noqa: E402

BOARD_SIZE, N_REQUESTS, N_PLAYOUTS, N_TASKS = 5, 6, 128, 32
N_WORKERS, TREE_CAP = 4, 512


def requests():
    return [GameRequest(rid=i, game=("hex", "gomoku")[i % 2],
                        board_size=BOARD_SIZE, n_playouts=N_PLAYOUTS,
                        n_tasks=N_TASKS, seed=i)
            for i in range(N_REQUESTS)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    dev = p.parse_args(argv).device
    # clean reference serve (also builds the kernels and warms every op)
    clean_eng = TPFIFOGameEngine(n_slots=2, grain=2, n_workers=N_WORKERS,
                                 tree_cap=TREE_CAP, device=dev)
    clean = requests()
    for r in clean:
        clean_eng.submit(r)
    clean_eng.run()
    builds = kernel_builds()
    print(f"clean serve: {len(clean_eng.finished)} answered, "
          f"{builds} builds of the kernel library")

    # chaos serve: same seeds, deterministic fault plan
    plan = FaultPlan.generate(seed=7, n_ticks=200, n_slots=4, rate=0.25)
    injector = FaultInjector(plan)
    eng = TPFIFOGameEngine(n_slots=2, grain=2, n_workers=N_WORKERS,
                           tree_cap=TREE_CAP, injector=injector,
                           quarantine_after=3, max_queue=16,
                           retry_backoff=(1, 8), device=dev)
    chaos = requests()
    for r in chaos:
        eng.submit(r)
    eng.run(max_ticks=20_000)

    st = eng.stats()
    fired = injector.summary()
    print(f"chaos serve: {fired['fired_total']} faults fired "
          f"{fired['fired']}, {st.n_retries} retries, "
          f"{st.n_quarantined} quarantined slots, {st.n_shed} shed")

    ref = {r.rid: r.result for r in clean}
    for r in sorted(chaos, key=lambda r: r.rid):
        res = r.result
        same = (np.array_equal(res["root_visits"],
                               ref[r.rid]["root_visits"])
                and np.array_equal(res["root_wins"],
                                   ref[r.rid]["root_wins"]))
        print(f"  req {r.rid}: {res['game']:>6} -> move {res['best_move']:>3}"
              f"  status={res['status']}  retries={res.get('retries', 0)}"
              f"  bit-identical to clean: {same}")
        assert same, "recovery must be bit-identical"
    grown = kernel_builds() - builds
    print(f"kernel library builds across chaos: {grown} (must be 0)")
    assert grown == 0
    return clean, chaos, fired


if __name__ == "__main__":
    main()
