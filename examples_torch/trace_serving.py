"""Trace a multi-tenant serve run and fit its measured work/span profile, on
the port.

The torch twin of ``examples/trace_serving.py``: four tenants (two Hex, two
Gomoku, mixed budgets and grains) share one TPFIFO game engine with the
observability stack attached: a ``TraceRecorder`` records admissions,
per-quantum spans, preemptions, device waits and builds of the kernel
library as Chrome/Perfetto trace-event JSON; a ``MetricsRegistry`` keeps
the running counters; the device counters (``SearchMetrics``) ride every
search. Then ``repro_torch.obsv.profile`` fits the per-round dispatch cost
to the recorded quantum spans and prints the measured-vs-analytic
parallelism table (the Fig 9 overlay, from this run's own trace). The trace
is written, validated and its path printed. ``--device cpu`` runs the
kernels' plain PyTorch versions.

    python examples_torch/trace_serving.py [--device cpu] [--trace PATH]
    # then load the trace in chrome://tracing or https://ui.perfetto.dev
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.obsv import MetricsRegistry, TraceRecorder, validate_trace  # noqa: E402
from repro_torch.obsv.profile import (  # noqa: E402
    fit_dispatch_profile,
    format_table,
    measured_vs_analytic,
)
from repro_torch.serve.games import GameRequest, TPFIFOGameEngine  # noqa: E402

BOARD_SIZE, N_WORKERS = 7, 8
# (rid, game, playouts, tasks, seed)
TENANTS = (("hex-big", "hex", 2048, 64, 0),
           ("gomoku-big", "gomoku", 2048, 64, 1),
           ("hex-quick", "hex", 256, 32, 2),
           ("gomoku-quick", "gomoku", 512, 16, 3))
TABLE_PLAYOUTS, TABLE_TASKS = 2048, (16, 64, 256, 1024)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace", default=os.path.join(tempfile.gettempdir(),
                                                   "trace_serving.json"))
    args = p.parse_args(argv)
    tracer = TraceRecorder(process_name="trace-serving-example")
    registry = MetricsRegistry()
    eng = TPFIFOGameEngine(n_slots=1, grain=2, preempt_quanta=1,
                           n_workers=N_WORKERS, metrics=True, tracer=tracer,
                           registry=registry, device=args.device)
    # a warm-up request per game class keeps the profiling spans clean
    # (the fit also leaves out spans that saw a build)
    for rid, game in (("warm-hex", "hex"), ("warm-gomoku", "gomoku")):
        eng.submit(GameRequest(rid=rid, game=game, board_size=BOARD_SIZE,
                               n_playouts=8, n_tasks=8, seed=9))
    eng.run()

    for rid, game, n, tasks, seed in TENANTS:
        eng.submit(GameRequest(rid=rid, game=game, board_size=BOARD_SIZE,
                               n_playouts=n, n_tasks=tasks, seed=seed))
    done = eng.run()

    for r in done:
        res = r.result
        if str(r.rid).startswith("warm"):
            continue
        dm = res["metrics"]
        print(f"{str(r.rid):>12}: {res['game']:>6} -> move "
              f"{res['best_move']:>3} value {res['root_value']:+.3f}  "
              f"{res['playouts']:>5} playouts, depth mean "
              f"{dm['depth_mean']:.2f}, {dm['expansions']} expansions, "
              f"leaf-collision rate {dm['leaf_collision_rate']:.2f}")

    n_events = validate_trace(tracer.to_dict())
    tracer.save(args.trace)
    assert validate_trace(args.trace) == n_events
    print(f"\ntrace: {n_events} events -> {args.trace} "
          f"(chrome://tracing or ui.perfetto.dev)")
    print("compile counts:", tracer.compile_counts())
    print("\ncounters:")
    for line in registry.exposition().strip().splitlines():
        if not line.startswith("#"):
            print(f"  {line}")

    profile = fit_dispatch_profile(tracer, n_workers=N_WORKERS)
    print(f"\nmeasured dispatch profile ({profile['n_spans']} spans, "
          f"{profile['n_excluded_compile']} compile-tainted excluded): "
          f"t_round {profile['t_round_s']*1e3:.2f} ms, "
          f"t_iter {profile['t_iter_s']*1e3:.3f} ms"
          + ("" if profile["identifiable"] else "  [rank-deficient fit]"))
    rows = measured_vs_analytic(profile, n_playouts=TABLE_PLAYOUTS,
                                task_counts=TABLE_TASKS, n_cores=61)
    print(format_table(rows))
    return done, profile


if __name__ == "__main__":
    main()
