"""Paper Fig 9 — measured GSCPM speedup overlaid on the Cilkview bound, on
the port.

The torch twin of ``benchmarks/fig9_mapping.py``. Runs the Fig 7
measurement for the FIFO discipline (or takes a finished one) and compares
each point against the analytic work/span bound with a dispatch burden
fitted from the measured per-round overhead.

Two burden fits produce two bound curves per point:

- ``bound`` — the single-point calibration: solve ``t_round`` so the bound
  meets the measured speedup at the finest grain;
- ``bound_measured`` — the trace fit: traced fifo searches across the
  grain sweep record per-round ``gscpm_round`` spans (the device
  synchronised inside each), ``repro_torch.obsv.profile.
  fit_dispatch_profile`` least-squares the per-round dispatch cost and the
  per-iteration cost out of the span durations, and the resulting
  ``DagModel`` carries MEASURED ``t_spawn``/``t_round``.

``profile_tasks`` picks the traced grains (default: the sweep's three
finest, as in the JAX twin); ``table`` is ``measured_vs_analytic`` at the
Phi's core and thread counts (``N_CORES``).

    PYTHONPATH=src python -m benchmarks_torch.fig9_mapping
"""

from __future__ import annotations

import json
import math

from repro_torch import rng
from repro_torch.core import game as game_mod
from repro_torch.core.cilkview import DagModel, speedup_bound
from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
from repro_torch.obsv import TraceRecorder
from repro_torch.obsv.profile import (fit_dispatch_profile, format_table,
                                      measured_dag_model, measured_vs_analytic)

from benchmarks_torch import fig7_speedup
from benchmarks_torch.common import device_stamp, resolve_device, save_result

N_CORES = (61, 244)     # the Phi's cores and hardware threads


def measure_dispatch_profile(n_playouts: int, n_workers: int,
                             board_size: int, task_counts,
                             seed: int = 0, device=None) -> dict:
    """Traced searches across the grain sweep -> fitted burden terms.

    One untraced search per grain first (the JAX twin's compile warm-up;
    here it warms the allocator at that grain's tree); the traced pass
    synchronises the device inside every round's span, so span durations
    include the device work they dispatched. A kernel build inside a span
    shows as a ``jit_compile`` instant and the fitter drops that span.
    """
    device = resolve_device(device)
    tracer = TraceRecorder(process_name="fig9-profile")
    tracer.watch_compiles("kernels")
    board = game_mod.make_game("hex", board_size).init_board(device)
    key = rng.key(seed, device)
    tree_cap = max(1 << 14, 4 * n_playouts)
    for n_tasks in task_counts:
        cfg = GSCPMConfig(game="hex", board_size=board_size,
                          n_playouts=n_playouts, n_tasks=n_tasks,
                          n_workers=n_workers, tree_cap=tree_cap)
        gscpm_search(board, 1, cfg, key, device=device)
        gscpm_search(board, 1, cfg, key, tracer=tracer, device=device)
    return fit_dispatch_profile(tracer, n_workers=n_workers)


def run(n_playouts: int = 2048, n_workers: int = 16, board_size: int = 9,
        measured: dict | None = None, profile_tasks=None,
        device=None) -> dict:
    device = resolve_device(device)
    if measured is None:
        measured = fig7_speedup.run(
            n_playouts=n_playouts, n_workers=n_workers,
            board_size=board_size, schedulers=("fifo",), device=device)
    seq_rate = measured["sequential_playouts_per_s"]
    t_iter = 1.0
    # fit the per-round dispatch burden from the finest-grain point
    pts = measured["curves"]["fifo"]
    finest = max(int(t) for t in pts)
    meas_fine = pts[str(finest)]["speedup"]
    grain = max(1, n_playouts // finest)
    # solve burden so bound(finest) == measured(finest)
    rounds = math.ceil(finest / n_workers)
    t1 = finest * grain
    tinf = grain + finest * 0.002
    tp_needed = t1 / max(meas_fine, 1e-9)
    t_round = max(0.0, (tp_needed - max(t1 / n_workers, tinf)) / rounds)

    # the trace fit: measured spans -> measured burden terms
    profile_tasks = (sorted({int(t) for t in pts})[-3:]
                     if profile_tasks is None else list(profile_tasks))
    profile = measure_dispatch_profile(n_playouts, n_workers, board_size,
                                       task_counts=profile_tasks,
                                       device=device)
    model_measured = measured_dag_model(profile)

    model = DagModel(t_iter=t_iter, t_spawn=0.002, t_round=t_round)
    overlay = {}
    for t_str, p in pts.items():
        t = int(t_str)
        g = max(1, n_playouts // t)
        overlay[t_str] = {
            "measured": p["speedup"],
            "bound": speedup_bound(t, g, n_workers, model),
            "bound_measured": speedup_bound(t, g, n_workers, model_measured),
        }
    tasks = sorted(int(t) for t in pts)
    tables = {str(c): measured_vs_analytic(profile, n_playouts, tasks, c)
              for c in N_CORES}
    return {
        "device": device_stamp(device),
        "n_playouts": n_playouts,
        "n_workers": n_workers,
        "fitted_t_round": t_round,
        "measured_t_round": profile["t_round_units"],
        "measured_t_spawn": profile["t_spawn_units"],
        "profile_tasks": profile_tasks,
        "dispatch_profile": profile,
        "sequential_playouts_per_s": seq_rate,
        "overlay": overlay,
        "measured_vs_analytic": tables,
        "table": {c: format_table(rows) for c, rows in tables.items()},
    }


if __name__ == "__main__":
    r = run()
    print(json.dumps(r, indent=1))
    save_result("fig9_mapping", r)
