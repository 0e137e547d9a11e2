"""Chaos serving: fault-rate sweep against the TPFIFO game engine, on the
port.

The torch twin of ``benchmarks/serve_chaos.py``: the mixed Hex + Gomoku
Poisson trace of ``serve_games`` is replayed at rising injected-fault rates
(seeded ``FaultPlan``s: dispatch failures, NaN root-stat poisoning, clock
stalls, duplicate submissions; ``repro_torch.serve.resilience``) and the
engine must absorb them: every request that is not shed completes, every
fully run answer equals the rate-0 run's bit for bit (recovery replays from
committed host snapshots, and round randomness depends only on the
schedule), and the whole sweep builds nothing after the warm-up
(``obsv.trace.kernel_builds``, reported under ``recompiles``).

Reported per rate: goodput (answered playouts/s), p50/p95 move latency,
retries, quarantined slots, fired faults, the sweep point's seconds and the
host's seconds blocked on the device (under injection that is the
snapshot copies, one per quantum). ``run()``'s defaults are the JAX twin's;
``CARD`` is the GPU's form: ``serve_games.CARD`` with the JAX budgets x32
and ``tree_cap`` sized to the largest budget (a snapshot copies a slot's
whole tree to the host every quantum).

    PYTHONPATH=src python -m benchmarks_torch.serve_chaos [--smoke|--full] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.obsv.trace import kernel_builds
from repro_torch.serve.games import GameRequest, TPFIFOGameEngine
from repro_torch.serve.resilience import FaultInjector, FaultPlan

from benchmarks_torch import serve_games
from benchmarks_torch.common import device_stamp, resolve_device, save_result
from benchmarks_torch.serve_games import (GAMES, _requests, differs_from_jax,
                                          make_trace)

JAX_DEFAULTS = dict(n_requests=16, slots=2, grain=2, n_workers=8,
                    board_size=7, rate_rps=64.0, tree_cap=1 << 11,
                    quarantine_after=3,
                    playout_choices=(128, 128, 256, 256, 512), seed=0,
                    chaos_seed=1234, fault_rates=(0.0, 0.05, 0.1, 0.2))
CARD = dict(board_size=11, n_workers=256, tree_cap=1 << 15,
            rate_rps=serve_games.CARD["rate_rps"],
            playout_choices=tuple(32 * n for n in
                                  JAX_DEFAULTS["playout_choices"]))


def serve_chaos(trace, fault_rate: float, *, slots, grain, n_workers,
                tree_cap, quarantine_after, chaos_seed, device,
                fault_horizon: int = 4096) -> tuple[dict, list]:
    """One serve of the trace at ``fault_rate``; returns (stats, requests)."""
    injector = None
    if fault_rate > 0:
        plan = FaultPlan.generate(seed=chaos_seed, n_ticks=fault_horizon,
                                  n_slots=slots * len(GAMES),
                                  rate=fault_rate)
        injector = FaultInjector(plan)
    eng = TPFIFOGameEngine(
        n_slots=slots, grain=grain, n_workers=n_workers, tree_cap=tree_cap,
        injector=injector, quarantine_after=quarantine_after,
        retry_backoff=(1, 8), device=device)
    reqs = _requests(trace)
    eng.run_trace(list(reqs), max_ticks=200_000)
    st = eng.stats().as_dict()
    answered = [r for _, r in reqs if r.result["status"] == "answered"]
    playouts = sum(r.result["playouts"] for r in answered)
    st.update(
        fault_rate=fault_rate,
        n_answered=len(answered),
        goodput_playouts_per_s=playouts / max(st["wall_s"], 1e-9),
        faults=(injector.summary() if injector else
                {"planned": 0, "fired": {}, "fired_total": 0}),
    )
    return st, [r for _, r in reqs]


def run(n_requests: int = 16, slots: int = 2, grain: int = 2,
        n_workers: int = 8, board_size: int = 7, rate_rps: float = 64.0,
        tree_cap: int = 1 << 11, quarantine_after: int = 3,
        playout_choices=(128, 128, 256, 256, 512), seed: int = 0,
        chaos_seed: int = 1234, fault_rates=(0.0, 0.05, 0.1, 0.2),
        smoke: bool = False, device=None) -> dict:
    if smoke:
        n_requests, board_size, tree_cap = 6, 5, 512
        playout_choices, rate_rps = (32, 64, 128), 50.0
        fault_rates = (0.0, 0.1, 0.3)
    device = resolve_device(device)
    playout_choices, fault_rates = tuple(playout_choices), tuple(fault_rates)

    trace = make_trace(n_requests, rate_rps, board_size, playout_choices,
                       seed)

    # builds off the clock: one tiny request per game class
    warm_eng = TPFIFOGameEngine(n_slots=slots, grain=grain,
                                n_workers=n_workers, tree_cap=tree_cap,
                                device=device)
    for g in GAMES:
        warm_eng.submit(GameRequest(rid=f"warm-{g}", game=g,
                                    board_size=board_size, n_playouts=8,
                                    n_tasks=2, seed=0))
    warm_eng.run()
    builds_before = kernel_builds()

    sweep, reference = [], None
    for rate in fault_rates:
        st, reqs = serve_chaos(
            trace, rate, slots=slots, grain=grain, n_workers=n_workers,
            tree_cap=tree_cap, quarantine_after=quarantine_after,
            chaos_seed=chaos_seed, device=device)
        # every non-shed request completed (the never-crash pin)
        unresolved = [r.rid for r in reqs if not r.done]
        assert not unresolved, f"rate {rate}: unresolved rids {unresolved}"
        if rate == 0.0:
            reference = {r.rid: r.result for r in reqs}
        elif reference is not None:
            # bit-identical recovery: every fully run answered search
            # equals the fault-free serve of the same seeds
            for r in reqs:
                res = r.result
                if (res["status"] != "answered"
                        or res["rounds"] != res["rounds_total"]):
                    continue
                ref = reference[r.rid]
                np.testing.assert_array_equal(res["root_visits"],
                                              ref["root_visits"])
                np.testing.assert_array_equal(res["root_wins"],
                                              ref["root_wins"])
        sweep.append(st)

    recompiles = kernel_builds() - builds_before
    assert recompiles == 0, \
        f"chaos churn built the kernel library {recompiles} times"

    base = sweep[0]
    knobs = dict(n_requests=n_requests, slots=slots, grain=grain,
                 n_workers=n_workers, board_size=board_size,
                 rate_rps=rate_rps, tree_cap=tree_cap,
                 quarantine_after=quarantine_after,
                 playout_choices=playout_choices, seed=seed,
                 chaos_seed=chaos_seed, fault_rates=fault_rates)
    return {
        "config": {**knobs, "playout_choices": list(playout_choices),
                   "fault_rates": list(fault_rates), "smoke": smoke,
                   "differs_from_jax": differs_from_jax(JAX_DEFAULTS,
                                                        **knobs)},
        "device": device_stamp(device),
        "sweep": sweep,
        "chaos": {
            "games": list(GAMES),
            "board": f"{board_size}x{board_size}",
            "n_requests": n_requests,
            "fault_rates": list(fault_rates),
            "goodput_playouts_per_s": [s["goodput_playouts_per_s"]
                                       for s in sweep],
            "latency_p50_s": [s["latency_p50"] for s in sweep],
            "latency_p95_s": [s["latency_p95"] for s in sweep],
            "seconds": [s["wall_s"] for s in sweep],
            "device_wait_s": [s["device_wait_s"] for s in sweep],
            "retries": [s["n_retries"] for s in sweep],
            "quarantined": [s["n_quarantined"] for s in sweep],
            "faults_fired": [s["faults"]["fired_total"] for s in sweep],
            "goodput_at_max_rate_vs_clean": (
                sweep[-1]["goodput_playouts_per_s"]
                / max(base["goodput_playouts_per_s"], 1e-9)),
            "recompiles": recompiles,
        },
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true",
                   help="tiny trace and 3 rates (a check that it runs)")
    p.add_argument("--full", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda")
    args = p.parse_args(argv)

    n = 32 if args.full else 16
    out = (run(smoke=True, device=args.device) if args.smoke
           else run(**CARD, n_requests=n, device=args.device))
    for s in out["sweep"]:
        print(f"rate {s['fault_rate']:.2f}: "
              f"{s['goodput_playouts_per_s']:10.0f} playouts/s goodput   "
              f"p50/p95 {s['latency_p50']*1e3:6.0f}/"
              f"{s['latency_p95']*1e3:6.0f} ms   "
              f"retries {s['n_retries']}  quarantined {s['n_quarantined']}  "
              f"faults fired {s['faults']['fired_total']}")
    c = out["chaos"]
    print(f"goodput at max fault rate vs clean: "
          f"{c['goodput_at_max_rate_vs_clean']:.2f}x   "
          f"recompiles across sweep: {c['recompiles']}")
    print("->", save_result("serve_chaos", out))
    return out


if __name__ == "__main__":
    main()
