"""Concurrent Hex + Gomoku searches through the TPFIFO game engine, on the
port.

The torch twin of ``examples/serve_games.py``: four search-a-move requests
(two Hex, two Gomoku, mixed playout budgets, one with a time-to-move
deadline) share one engine. Each game class gets its own slot pool; the
engine interleaves m-round quanta with tail-requeue preemption, and every
answer is bit-identical to running that search alone. ``--device cpu``
runs the kernels' plain PyTorch versions.

    python examples_torch/serve_games.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.serve.games import GameRequest, TPFIFOGameEngine  # noqa: E402

BOARD_SIZE, N_WORKERS = 7, 8
# (rid, game, playouts, tasks, seed, deadline in seconds)
REQUESTS = (("hex-big", "hex", 2048, 64, 0, None),
            ("gomoku-big", "gomoku", 2048, 64, 1, None),
            # small requests arrive behind the big ones; preemption lets
            # them slip between quanta instead of waiting out the searches
            ("hex-quick", "hex", 256, 32, 2, None),
            ("gomoku-dl", "gomoku", 4096, 64, 3, 4.5))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    dev = p.parse_args(argv).device
    eng = TPFIFOGameEngine(n_slots=1, grain=2, preempt_quanta=1,
                           n_workers=N_WORKERS, device=dev)
    for rid, game, n, tasks, seed, deadline in REQUESTS:
        eng.submit(GameRequest(rid=rid, game=game, board_size=BOARD_SIZE,
                               n_playouts=n, n_tasks=tasks, seed=seed,
                               deadline_s=deadline))
    done = eng.run()

    for r in done:
        res = r.result
        tag = "  <- deadline, partial stats" if res["deadline_expired"] else ""
        print(f"{str(r.rid):>10}: {res['game']:>6} -> move {res['best_move']:>3} "
              f"value {res['root_value']:+.3f}  "
              f"{res['playouts']:>5} playouts "
              f"({res['rounds']}/{res['rounds_total']} rounds, "
              f"{res['preemptions']} preemptions){tag}")
    st = eng.stats()
    print(f"\n{st.n_finished} searches, {st.quanta} quanta, "
          f"{st.n_preemptions} preemptions; move latency p50/p95 "
          f"{st.latency_p50:.2f}/{st.latency_p95:.2f} s")
    return done


if __name__ == "__main__":
    main()
