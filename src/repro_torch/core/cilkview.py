"""Analytic work/span scaling model (paper Fig 5 / Fig 9 analogue).

Port of ``repro.core.cilkview``: pure numpy, the port's own copy (the two
packages share no code).

Cilkview reports burdened-dag lower bounds on speedup from a serial
instrumented run: speedup(P) <= min(P, T1 / T_inf). For GSCPM with nTasks
tasks of grain m on P lanes the dag is a fork-join of nTasks serial chains:

    T1     = nTasks * m * t_iter                 (total work)
    T_inf  = m * t_iter + nTasks * t_spawn       (longest chain + spawn chain)
    T_P   >= max(T1 / P, T_inf) + burden

so available parallelism = T1 / T_inf → nTasks as m grows, capped by spawn
overhead as m shrinks — the two regimes of the paper's Table I. The burden
term models per-task scheduling cost (the paper's "spawn and scheduling
overhead"); on our harness it is the per-round dispatch cost, measured by
benchmarks_torch/fig7_speedup.py and fed back into Fig 9's overlay.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DagModel:
    t_iter: float = 1.0       # cost of one UCT iteration (arbitrary units)
    t_spawn: float = 0.002    # per-task spawn/schedule burden, in t_iter units
    t_round: float = 0.0      # per-round dispatch burden (host), t_iter units


def work(n_tasks: int, grain: int, m: DagModel) -> float:
    return n_tasks * grain * m.t_iter


def span(n_tasks: int, grain: int, m: DagModel) -> float:
    return grain * m.t_iter + n_tasks * m.t_spawn


def parallelism(n_tasks: int, grain: int, m: DagModel) -> float:
    return work(n_tasks, grain, m) / span(n_tasks, grain, m)


def speedup_bound(n_tasks: int, grain: int, n_cores: int, m: DagModel) -> float:
    """Cilkview-style lower-bound estimate of achievable speedup on P cores."""
    t1 = work(n_tasks, grain, m)
    tinf = span(n_tasks, grain, m)
    rounds = int(np.ceil(n_tasks / n_cores))
    tp = max(t1 / n_cores, tinf) + rounds * m.t_round
    return t1 / tp


def burdened_span(n_tasks: int, grain: int, n_cores: int,
                  m: DagModel) -> float:
    """Span plus the serial dispatch burden the P-core execution pays: each
    of the ceil(nTasks/P) rounds costs one host dispatch (``t_round``)."""
    rounds = int(np.ceil(n_tasks / n_cores))
    return span(n_tasks, grain, m) + rounds * m.t_round


def burdened_parallelism(n_tasks: int, grain: int, n_cores: int,
                         m: DagModel) -> float:
    """Cilkview's *burdened parallelism*: T1 over the burdened span — the
    parallelism estimate that survives scheduling overhead, which is what a
    MEASURED dag model (``repro_torch.obsv.profile.measured_dag_model``) makes
    honest for the Fig 9 overlay."""
    return work(n_tasks, grain, m) / burdened_span(n_tasks, grain, n_cores, m)


def profile(n_playouts: int, task_counts: list[int], core_counts: list[int],
            m: DagModel | None = None) -> dict[int, list[float]]:
    """speedup_bound curves: {n_tasks: [bound per core count]} (paper Fig 5)."""
    m = m or DagModel()
    out: dict[int, list[float]] = {}
    for t in task_counts:
        grain = max(1, n_playouts // t)
        out[t] = [speedup_bound(t, grain, p, m) for p in core_counts]
    return out
