"""Task→lane scheduling disciplines (the paper's experimental axis).

The paper compares work-stealing runtimes (Cilk Plus, TBB) against a FIFO
work-sharing thread pool (TPFIFO) and finds FIFO equal-or-better for MCTS's
irregular tasks. On SPMD hardware there is no dynamic stealing — the
scheduling freedom left is how task grains map onto lanes between sync
steps. This module is pure numpy, the port's own copy of
``repro.core.scheduler`` (the two packages share no code). We implement:

- ``fifo``          static FIFO work-sharing: round r gives lane w task
                    ``r*W + w``; the last round has masked (idle) lanes when
                    W ∤ nTasks — the measurable load-imbalance cost.
- ``rebalance``     the stealing analogue: playouts are fungible, so remaining
                    work is re-split across ALL lanes every round (no lane
                    idles until the final sub-width round).
- ``one_per_core``  traditional tree parallelism (paper's baseline):
                    nTasks = nLanes, one monolithic task per lane.
- ``sequential``    W = 1 (paper Table II baseline).

A schedule is a list of Rounds; ``gscpm_search`` runs one chunk per
round. Host-side dispatch per round is the spawn-overhead analogue: many tiny
rounds (fine grain) pay it often, exactly the paper's Table I lower row.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Round:
    m: int                 # iterations every active lane runs this round
    task_ids: np.ndarray   # (W,) int32 RNG-stream ids per lane
    active: np.ndarray     # (W,) bool


def make_schedule(n_playouts: int, n_tasks: int, n_workers: int,
                  policy: str) -> list[Round]:
    W = n_workers
    if policy == "sequential":
        W = 1
        n_tasks = 1
    if policy == "one_per_core":
        n_tasks = W
    n_tasks = max(1, min(n_tasks, n_playouts))
    m = max(1, n_playouts // n_tasks)

    if policy in ("fifo", "one_per_core", "sequential"):
        rounds = []
        n_rounds = math.ceil(n_tasks / W)
        for r in range(n_rounds):
            ids = r * W + np.arange(W, dtype=np.int32)
            active = ids < n_tasks
            rounds.append(Round(m=m, task_ids=ids, active=active))
        return rounds

    if policy == "rebalance":
        total = n_tasks * m  # same playout budget as fifo
        rounds = []
        rem = total
        r = 0
        while rem >= W:
            mr = max(1, min(m, rem // W))
            ids = r * W + np.arange(W, dtype=np.int32)
            rounds.append(Round(m=mr, task_ids=ids,
                                active=np.ones(W, dtype=bool)))
            rem -= mr * W
            r += 1
        if rem > 0:
            ids = r * W + np.arange(W, dtype=np.int32)
            rounds.append(Round(m=1, task_ids=ids,
                                active=np.arange(W) < rem))
        return rounds

    raise ValueError(f"unknown scheduler policy: {policy!r}")


def quantum_plan(n_steps: int, grain: int, policy: str) -> list[int]:
    """One request's work split into grain-sized quanta (TPFIFO serving).

    The serving layer (``repro_torch.serve.tpfifo``) treats each admitted
    request as the paper's "logical task of fungible iterations": ``n_steps``
    micro-steps
    (decode ticks or MCTS commit rounds) dispatched as a sequence of quanta.
    The split reuses ``make_schedule`` with a single lane — the request itself
    is the worker — so the serving disciplines are literally the paper's:

    - ``fifo`` / ``rebalance``  uniform quanta of ~``grain`` steps; the
                                request yields the device at every boundary.
    - ``one_per_core``          one monolithic quantum (run-to-completion):
                                the paper's one-task-per-lane baseline.
    - ``sequential``            alias of ``one_per_core`` at W=1.

    ``make_schedule`` floors its budget to ``n_tasks * m``; a request is not
    fungible, so the last quantum is topped up to cover ``n_steps`` exactly.
    """
    n_steps = max(1, n_steps)
    n_tasks = max(1, math.ceil(n_steps / max(1, grain)))
    rounds = make_schedule(n_steps, n_tasks, 1, policy)
    plan = [r.m for r in rounds if bool(r.active.any())]
    short = n_steps - sum(plan)
    if short > 0:
        plan[-1] += short
    return plan


def schedule_stats(schedule: list[Round]) -> dict:
    """Lane-utilization accounting for a schedule (used by benchmarks)."""
    lane_iters = sum(int(r.active.sum()) * r.m for r in schedule)
    total_iters = sum(r.active.shape[0] * r.m for r in schedule)
    return {
        "rounds": len(schedule),
        "lane_iterations": lane_iters,
        "masked_lane_iterations": total_iters - lane_iters,
        "utilization": lane_iters / max(1, total_iters),
    }
