"""Failure model, deterministic fault injection, and recovery primitives
for the TPFIFO serving stack (port of ``repro.serve.resilience``; DESIGN.md
§17).

The paper's thread-pool result is a *production* claim: the FIFO pool must
survive irregular workloads, wedged workers, and corrupted results, not
merely outrun work stealing on a good day. This module gives the serving
layer a failure vocabulary and the tools to provoke and absorb each
failure class:

- ``FaultPlan`` / ``FaultInjector`` — a *seeded, deterministic* schedule of
  ``(tick, slot, kind)`` fault events (pure numpy: the same seed gives the
  same events as the JAX package's). Chaos runs are reproducible runs.
- fault kinds (``FAULT_KINDS``): ``dispatch_error`` (the slot's quantum
  dispatch raises — contained to the slot), ``poison_nan`` (the slot's
  root statistics are corrupted after a quantum — the *result guard*
  catches it at retirement), ``clock_stall`` (the engine clock jumps
  forward — deadlines fire, never poison a slot), ``duplicate_submit`` (a
  pending request is submitted again — admission dedups).
- ``validate_result`` — the host-side result guard on the retired root
  summary.
- ``snapshot_search`` / ``restore_search`` — host copies of the search's
  tensors at committed round boundaries, flattened through
  ``repro_torch.checkpoint.store``'s path vocabulary. Because RNG streams
  depend only on ``(key, round.task_ids)``, a search restored from round k
  and replayed is **bit-identical** to one that never failed.

The port updates trees in place (``core.gscpm``), so the two places where
that matters are explicit here: ``poison_root_stats`` writes into the tree
it is given, and a snapshot is a COPY on the host (a ``.numpy()`` view of a
CPU tensor would follow the search's later writes), restored into fresh
tensors on the device the snapshot's template records.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import store

FAULT_KINDS = ("dispatch_error", "poison_nan", "clock_stall",
               "duplicate_submit")

# driver-level kinds are applied by ``TPFIFODriver._tick`` itself; the
# slot-level kinds are consumed by the engine around each slot's quantum
DRIVER_KINDS = ("clock_stall", "duplicate_submit")
SLOT_KINDS = ("dispatch_error", "poison_nan")


class InjectedFaultError(RuntimeError):
    """Raised in place of a quantum dispatch to simulate device failure."""


class ResultGuardError(RuntimeError):
    """A retired answer failed the host-side result guard."""


# ------------------------------------------------------------- fault plan ----
@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One planned fault: at engine tick ``tick``, against ``slot``.

    ``slot`` is a flat slot index for the slot-level kinds; for
    ``duplicate_submit`` it picks the victim request (mod the number of
    pending requests); ``clock_stall`` ignores it. ``stall_s`` is the
    simulated host-clock jump for ``clock_stall`` events.
    """
    tick: int
    slot: int
    kind: str
    stall_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seeded schedule of fault events."""

    events: tuple[FaultEvent, ...]
    seed: int | None = None
    rate: float = 0.0

    @classmethod
    def generate(cls, seed: int, n_ticks: int, n_slots: int, rate: float,
                 kinds: tuple[str, ...] = FAULT_KINDS,
                 stall_s: float = 0.25) -> "FaultPlan":
        """Bernoulli(rate) fault per (tick, slot) cell, kind drawn uniformly
        from ``kinds``. Pure function of its arguments: chaos sweeps at the
        same seed replay the identical fault sequence.
        """
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}; "
                                 f"known: {FAULT_KINDS}")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        rng = np.random.default_rng(seed)
        events = []
        for tick in range(n_ticks):
            for slot in range(n_slots):
                if rng.random() < rate:
                    kind = str(kinds[int(rng.integers(len(kinds)))])
                    events.append(FaultEvent(
                        tick=tick, slot=slot, kind=kind,
                        stall_s=stall_s if kind == "clock_stall" else 0.0))
        return cls(events=tuple(events), seed=seed, rate=rate)


class FaultInjector:
    """Feeds a ``FaultPlan`` into a running driver, tick by tick.

    The driver calls ``begin_tick`` at the top of every ``_tick`` and
    applies the returned driver-level events itself (clock stalls,
    duplicate submissions); the engine polls ``dispatch_fault``/``poison``
    around each slot's quantum. Events that target an idle slot simply do
    not fire — ``fired`` vs ``len(plan.events)`` reports the hit rate.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_tick: dict[int, list[FaultEvent]] = collections.defaultdict(
            list)
        for ev in plan.events:
            self._by_tick[ev.tick].append(ev)
        self._current: list[FaultEvent] = []
        self.fired: collections.Counter = collections.Counter()

    def begin_tick(self, tick: int) -> list[FaultEvent]:
        """Arm this tick's events; return the driver-level ones."""
        self._current = list(self._by_tick.get(tick, ()))
        return [ev for ev in self._current if ev.kind in DRIVER_KINDS]

    def _take(self, kind: str, slot: int) -> FaultEvent | None:
        for i, ev in enumerate(self._current):
            if ev.kind == kind and ev.slot == slot:
                del self._current[i]
                return ev
        return None

    def dispatch_fault(self, slot: int) -> FaultEvent | None:
        return self._take("dispatch_error", slot)

    def poison(self, slot: int) -> FaultEvent | None:
        return self._take("poison_nan", slot)

    def record_fired(self, ev: FaultEvent) -> None:
        self.fired[ev.kind] += 1

    def summary(self) -> dict:
        return {"planned": len(self.plan.events),
                "fired": dict(self.fired),
                "fired_total": sum(self.fired.values())}


def poison_root_stats(tree):
    """Corrupt a tree's root-region statistics (simulated device-memory
    corruption): NaN wins at the root and its first child, a negative
    visit count on the child. Written IN PLACE (the port's trees are
    updated in place; the last committed snapshot is a host copy, so a
    rollback still restores the clean state) and returned. On a forest the
    index is the member axis, as the JAX package's ``.at[0]`` is."""
    tree.wins[0] = float("nan")
    tree.wins[1] = float("nan")
    tree.visits[1] = -1.0
    return tree


# ------------------------------------------------------------ result guard ----
def validate_result(res: dict,
                    expected_playouts: int | None = None) -> list[str]:
    """Summary-level invariants a retired answer must satisfy.

    The cheap cousin of ``core/tree.check_invariants``: it sees only the
    dense root summary (``core/tree.root_summary``), so it runs on every
    retirement at O(n_actions) host cost. Returns the list of violations
    (empty == valid). The serving engine converts violations into retries
    from the last committed snapshot.

    ``expected_playouts`` enables the exact visit-conservation check (sum
    of root-child visits == committed playouts). It only holds for COLD
    searches — a warm-started tree carries retained evidence whose child
    sum is not exactly recoverable from the root count — so warm
    retirements pass ``None`` and rely on the finiteness/range checks.
    """
    bad: list[str] = []
    visits = np.asarray(res["root_visits"], dtype=np.float64)
    wins = np.asarray(res["root_wins"], dtype=np.float64)
    finite_v = bool(np.isfinite(visits).all())
    if not finite_v or (visits < 0).any():
        bad.append("root visits not finite and non-negative")
    if not np.isfinite(wins).all():
        bad.append("root wins not finite")
    elif finite_v and ((wins < 0) | (wins > np.maximum(visits, 0))).any():
        bad.append("root wins outside [0, visits]")
    total = float(visits.sum()) if finite_v else -1.0
    if expected_playouts is not None and total != float(expected_playouts):
        bad.append(f"visit conservation broken: root visits sum {total} "
                   f"!= committed playouts {expected_playouts}")
    if total > 0 and not np.isfinite(res["root_value"]):
        bad.append("root value not finite")
    if not -1 <= int(res["best_move"]) < len(visits):
        bad.append(f"best_move {res['best_move']} out of range")
    return bad


def snapshot_is_clean(snap: "SearchSnapshot") -> bool:
    """Cheap sanity screen on an already-host-resident snapshot: float tree
    arrays finite, visit counts non-negative.

    This gates snapshot COMMITMENT in the engine: corruption that slipped
    in before the copy (a poisoned quantum that ran before detection) must
    not overwrite the last good commit point, or a guard rejection at
    retirement would roll back into the corruption and retry forever.
    """
    for path, arr in snap.tree_flat.items():
        a = np.asarray(arr)
        if a.dtype.kind == "f":
            if not np.isfinite(a).all():
                return False
            if path.endswith("visits") and (a < 0).any():
                return False
    return True


# -------------------------------------------------------------- snapshots ----
@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Template leaf of a snapshot: what ``_rebuild`` needs to make the
    tensor again (the port's ``jax.ShapeDtypeStruct``, plus the device)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    device: torch.device


@dataclasses.dataclass
class SearchSnapshot:
    """Host-side copy of a search at a committed round boundary.

    Tensors are flattened to a ``path -> np.ndarray`` dict through
    ``checkpoint.store``'s machinery, plus ``TensorSpec`` templates to
    rebuild the exact structures. Restoring and replaying the remaining
    rounds is bit-identical to never having failed (round RNG depends only
    on the schedule, never on wall-clock).
    """
    round_idx: int
    playouts: int
    out_len: int
    tree_flat: dict[str, np.ndarray]
    tree_template: Any
    metrics_flat: dict[str, np.ndarray] | None
    metrics_template: Any


def _host_flat(tree: Any) -> dict[str, np.ndarray]:
    # copy=True: on the CPU ``.cpu()`` is the tensor itself, whose later
    # in-place updates a plain ``.numpy()`` view would follow
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in store._flatten(tree).items()}


def _template(tree: Any) -> Any:
    flat = {k: TensorSpec(tuple(v.shape), v.dtype, v.device)
            for k, v in store._flatten(tree).items()}
    return store._unflatten_like(tree, flat)


def _rebuild(template: Any, flat: dict[str, np.ndarray]) -> Any:
    specs = store._flatten(template)
    fresh = {k: torch.tensor(flat[k], dtype=spec.dtype, device=spec.device)
             for k, spec in specs.items() if k in flat}
    return store._unflatten_like(template, fresh)


def snapshot_search(tree, metrics, round_idx: int, playouts: int,
                    out_len: int) -> SearchSnapshot:
    """Copy the device-resident search state to host memory (blocking)."""
    return SearchSnapshot(
        round_idx=round_idx, playouts=playouts, out_len=out_len,
        tree_flat=_host_flat(tree), tree_template=_template(tree),
        metrics_flat=None if metrics is None else _host_flat(metrics),
        metrics_template=None if metrics is None else _template(metrics))


def restore_search(snap: SearchSnapshot):
    """Rebuild ``(tree, metrics)`` as fresh tensors from a snapshot."""
    tree = _rebuild(snap.tree_template, snap.tree_flat)
    metrics = (None if snap.metrics_flat is None
               else _rebuild(snap.metrics_template, snap.metrics_flat))
    return tree, metrics
