"""Paper Fig 5 — Cilkview-style scalability profile for GSCPM (analytic).

The port's twin of ``benchmarks/fig5_cilkview.py``, on the port's
``core/cilkview.py``: analytic work/span speedup lower bounds as a function
of nTasks, for 61 and 244 "cores" (the Phi's core/thread counts) plus a
16-lane harness width. No device is involved: the numbers are the model's.
Reproduces the paper's qualitative claim: fine-grained task counts
(nTasks >> nCores) are required for near-perfect intrinsic parallelism;
16384 tasks ~ perfect speedup on 61 cores.

    PYTHONPATH=src python -m benchmarks_torch.fig5_cilkview
"""

from __future__ import annotations

import json

from repro_torch.configs.hex_paper import PAPER, TASK_SWEEP
from repro_torch.core.cilkview import DagModel, profile

from benchmarks_torch.common import save_result


def run(n_playouts: int | None = None) -> dict:
    n = n_playouts or PAPER.n_playouts
    cores = [16, 61, 244]
    curves = profile(n, TASK_SWEEP, cores, DagModel())
    return {
        "device": None,            # analytic: no device ran anything
        "n_playouts": n,
        "core_counts": cores,
        "task_sweep": TASK_SWEEP,
        "speedup_bounds": {str(t): v for t, v in curves.items()},
        "note": "bound(61 cores, 16384 tasks) ~ 61 == paper's near-perfect "
                "profile at fine grain",
    }


if __name__ == "__main__":
    r = run()
    print(json.dumps(r, indent=1))
    save_result("fig5_cilkview", r)
