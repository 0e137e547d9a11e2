"""TPFIFO serving: a work-sharing FIFO request scheduler over device slots.

Port of ``repro.serve.tpfifo``, its model-free part. The paper's headline
result is that a plain FIFO work-sharing thread pool (TPFIFO) with
controlled task grain out-scales work-stealing runtimes for irregular MCTS
workloads. This module carries that scheduler to the serving layer: the
*queue* holds requests, the *workers* are the B fixed device slots of an
engine, and the *task grain* is ``m`` micro-steps (MCTS schedule rounds)
per dispatch.

- ``TPFIFODriver`` — the host-side pool: one FIFO queue of ``Ticket``s, B
  slots, per-request quantum plans derived from
  ``repro_torch.core.scheduler.quantum_plan`` (``fifo``/``rebalance`` slice
  requests into uniform grains, ``one_per_core`` runs each request to
  completion), tail-requeue preemption with a progress guard, retry with
  capped exponential backoff, slot quarantine, load shedding, and
  per-request telemetry summarized by ``QueueStats``. It is host code
  only and reads no tensor; ``repro_torch.serve.games.TPFIFOGameEngine``
  subclasses it.

Not ported yet, ROADMAP.md item A10 (LM half): the LM engines and their
quantum — ``LaneState``, ``sample_tokens``, ``run_quantum``, ``load_slot``,
``free_slot``, ``reset_slot_rows``, ``TPFIFOEngine`` and
``TPFIFOMCTSEngine``. Those names exist and refuse, naming the item.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
import warnings
from typing import Any

import numpy as np

from repro_torch.core import scheduler as sched

# ------------------------------------------------------------------ queue ----
@dataclasses.dataclass
class Ticket:
    """Queue entry wrapping one request, with scheduling state + telemetry.

    ``req`` is duck-typed: ``TPFIFODriver`` itself needs only ``rid``, ``out``
    (a list that grows with committed progress — the preemption guard's
    currency), and ``done``. The game-search engine reads its own fields
    (``repro_torch.serve.games.GameRequest``).
    """
    req: Any
    t_submit: float
    t_admit: float | None = None        # first admission
    t_done: float | None = None
    quanta: int = 0                     # completed quanta (all segments)
    quanta_at_admit: int = 0            # snapshot at current admission
    preemptions: int = 0
    retries: int = 0                    # failure-driven requeues (faults,
                                        # guard rejections) — NOT preemptions
    not_before: int = 0                 # earliest tick this ticket may be
                                        # re-admitted (retry backoff gate)
    seg_base: int = 0                   # len(req.out) at current admission
    plan: list[int] | None = None       # remaining quantum sizes
    plan_idx: int = 0
    q_rem: int = 0                      # micro-steps left in current quantum


@dataclasses.dataclass(frozen=True)
class QueueStats:
    """Aggregate per-request telemetry for one serve run (seconds)."""
    n_finished: int
    n_preemptions: int
    tokens: int
    quanta: int
    wall_s: float
    throughput_tok_s: float
    queue_wait_p50: float
    queue_wait_p95: float
    service_p50: float
    service_p95: float
    latency_p50: float
    latency_p95: float
    # resilience telemetry: failure-driven requeues, shed + still-
    # unfinished request counts, quarantined slots — defaults keep older
    # call sites and serialized stats comparable
    n_retries: int = 0
    n_shed: int = 0
    n_quarantined: int = 0
    n_unfinished: int = 0
    # host seconds spent BLOCKED on device readback (snapshots, retirement
    # summaries, lane-state pulls) across the whole run — the async-
    # pipelining currency (DESIGN.md §18): the pipelined engine hides this
    # time under the next tick's device work, the blocking one eats it
    device_wait_s: float = 0.0

    @classmethod
    def from_tickets(cls, tickets: list[Ticket], *, n_shed: int = 0,
                     n_quarantined: int = 0,
                     device_wait_s: float = 0.0) -> "QueueStats":
        # progress accounting covers ALL tickets — a run that preempted
        # requests but finished none still reports its preemptions, quanta,
        # and committed tokens (they live in req.out across requeues);
        # latency percentiles are defined only for finished requests.
        n_preempt = sum(t.preemptions for t in tickets)
        quanta = sum(t.quanta for t in tickets)
        tokens = sum(len(t.req.out) for t in tickets)
        extras = dict(
            n_retries=sum(t.retries for t in tickets), n_shed=n_shed,
            n_quarantined=n_quarantined,
            n_unfinished=sum(1 for t in tickets if t.t_done is None),
            device_wait_s=device_wait_s)
        done = [t for t in tickets if t.t_done is not None]
        if not done:
            return cls(0, n_preempt, tokens, quanta, 0.0, 0.0,
                       *([0.0] * 6), **extras)
        waits = np.asarray([t.t_admit - t.t_submit for t in done])
        service = np.asarray([t.t_done - t.t_admit for t in done])
        latency = np.asarray([t.t_done - t.t_submit for t in done])
        t0 = min(t.t_submit for t in done)
        wall = max(t.t_done for t in done) - t0
        tokens_done = sum(len(t.req.out) for t in done)
        p = np.percentile
        return cls(
            n_finished=len(done),
            n_preemptions=n_preempt,
            tokens=tokens,
            quanta=quanta,
            wall_s=wall,
            throughput_tok_s=tokens_done / max(wall, 1e-9),
            queue_wait_p50=float(p(waits, 50)),
            queue_wait_p95=float(p(waits, 95)),
            service_p50=float(p(service, 50)),
            service_p95=float(p(service, 95)),
            latency_p50=float(p(latency, 50)),
            latency_p95=float(p(latency, 95)),
            **extras,
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ----------------------------------------------------------------- driver ----
class TPFIFODriver:
    """Host-side work-sharing FIFO pool: one queue, B device-slot workers.

    Subclasses implement ``step()`` (one engine tick) and ``_load_slot``
    (move an admitted ticket's request into device-slot state). Lockstep
    engines pass ``grain=None`` (no quantum plans, no preemption); grained
    engines get per-request plans from ``scheduler.quantum_plan`` and call
    ``_tick_m()`` for each dispatch's micro-step count.

    Observability (DESIGN.md §15) is attach-to-enable: ``tracer`` (a
    ``repro_torch.obsv.TraceRecorder``) records admission/retire/preempt
    instants, per-tick spans, queue-depth counter tracks, and kernel-build
    events (``jit_compile``);
    ``registry`` (a ``repro_torch.obsv.MetricsRegistry``) keeps running
    counters/gauges. Both default to ``None`` and cost nothing detached.
    """

    def __init__(self, n_slots: int, grain: int | None = None,
                 policy: str = "fifo", preempt_quanta: int | None = None,
                 max_queue: int | None = None,
                 quarantine_after: int | None = None, injector=None,
                 retry_backoff: tuple[int, int] = (1, 8),
                 tracer=None, registry=None):
        if grain is not None and policy not in (
                "fifo", "rebalance", "one_per_core", "sequential"):
            raise ValueError(f"unknown TPFIFO policy: {policy!r}")
        if grain is not None and grain < 1:
            raise ValueError(f"grain must be >= 1, got {grain}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if quarantine_after is not None and quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}")
        self.B = n_slots
        self.grain = grain
        self.policy = policy
        self.preempt_quanta = preempt_quanta
        # resilience knobs (DESIGN.md §17): bounded admission per queue
        # class, slot quarantine after k CONSECUTIVE failures, retry
        # backoff of min(base * 2**(retries-1), cap) ticks, and an optional
        # deterministic FaultInjector driving chaos
        self.max_queue = max_queue
        self.quarantine_after = quarantine_after
        self.injector = injector
        self.backoff_base, self.backoff_cap = retry_backoff
        self.tracer = tracer
        self.registry = registry
        self.queue: collections.deque[Ticket] = collections.deque()
        self.active: list[Ticket | None] = [None] * n_slots
        self.finished: list[Any] = []            # Request objects (public)
        self.finished_tickets: list[Ticket] = []
        self.shed: list[Any] = []                # load-shed Request objects
        self.quarantined: set = set()            # slot keys out of service
        self._slot_strikes: dict = {}            # slot key -> consecutive fails
        self.admission_order: list[Any] = []     # rids, in admission order
        self.device_wait_s = 0.0                 # host blocked on readback
        self._t0 = time.perf_counter()
        self._ticks = 0

    # -- clock / queue ----------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    @contextlib.contextmanager
    def _device_wait(self, what: str, rid=None):
        """Account (and trace) a host block on device readback.

        Wrap every wait on the device (a synchronise, a ``.cpu()`` of a
        device tensor, an event wait) on the serving path in one of these:
        ``stats().device_wait_s`` and the Perfetto ``device_wait`` spans are
        how the pipelining win is MEASURED rather than inferred (DESIGN.md
        §18).
        """
        args = {"what": what}
        if rid is not None:
            args["rid"] = rid
        t0 = time.perf_counter()
        with (self.tracer.span("device_wait", args) if self.tracer
              else contextlib.nullcontext()):
            try:
                yield
            finally:
                self.device_wait_s += time.perf_counter() - t0

    def _queue_load(self, req) -> int:
        """Pending requests competing with ``req`` for admission (the
        ``max_queue`` currency). Engines with partitioned slot pools narrow
        this to the request's own class."""
        return len(self.queue)

    def _is_pending(self, rid) -> bool:
        return (any(t is not None and t.req.rid == rid for t in self.active)
                or any(t.req.rid == rid for t in self.queue))

    def _shed(self, req) -> None:
        """Load shedding: retire the request immediately with
        ``status="shed"`` instead of raising or queueing unboundedly."""
        req.done = True
        req.result = {"status": "shed", "reason": "queue_full"}
        self.shed.append(req)
        if self.tracer:
            self.tracer.instant("shed", {"rid": req.rid,
                                         "queue_depth": len(self.queue)})
        if self.registry:
            self.registry.counter(
                "serve_shed_total",
                "requests shed at admission (queue full)").inc()

    def submit(self, req, at: float | None = None) -> bool:
        """Enqueue a request; ``at`` overrides the submit timestamp (trace
        replay records the scheduled arrival, not the injection instant).

        Returns False without queueing when the request is a duplicate of a
        still-pending rid (client retry storms must not double-serve — the
        engine's state table is keyed by rid) or when ``max_queue`` sheds
        it (``req.result["status"] == "shed"``); True when queued.
        """
        if self._is_pending(req.rid):
            if self.tracer:
                self.tracer.instant("duplicate_dropped", {"rid": req.rid})
            if self.registry:
                self.registry.counter(
                    "serve_duplicates_dropped_total",
                    "duplicate submissions of a pending rid dropped").inc()
            return False
        if self.max_queue is not None and self._queue_load(req) >= \
                self.max_queue:
            self._shed(req)
            return False
        self.queue.append(Ticket(req=req,
                                 t_submit=self._now() if at is None else at))
        return True

    def has_work(self) -> bool:
        return bool(self.queue) or any(t is not None for t in self.active)

    def _next_admissible(self, held: list[Ticket]) -> Ticket | None:
        """Pop the first queue ticket past its retry-backoff gate; gated
        tickets go to ``held`` and keep their FIFO position."""
        while self.queue:
            t = self.queue.popleft()
            if t.not_before > self._ticks:
                held.append(t)
                continue
            return t
        return None

    def _restore_held(self, held: list[Ticket]) -> None:
        for t in reversed(held):
            self.queue.appendleft(t)

    # -- slot lifecycle ---------------------------------------------------
    def _admit_free_slots(self) -> list[int]:
        """FIFO admission: every free, non-quarantined slot takes the first
        admissible (backoff-gated tickets keep their place) queue head."""
        admitted = []
        held: list[Ticket] = []
        for s in range(self.B):
            if self.active[s] is None and s not in self.quarantined \
                    and self.queue:
                t = self._next_admissible(held)
                if t is None:
                    break
                if t.t_admit is None:
                    t.t_admit = self._now()
                t.quanta_at_admit = t.quanta
                t.seg_base = len(t.req.out)
                if self.grain is not None:
                    t.plan = sched.quantum_plan(self._work_estimate(t),
                                                self.grain, self.policy)
                    t.plan_idx = 0
                    t.q_rem = t.plan[0]
                self.active[s] = t
                self.admission_order.append(t.req.rid)
                self._load_slot(s, t)
                admitted.append(s)
                if self.tracer:
                    self.tracer.instant("admission", {
                        "rid": t.req.rid, "slot": s,
                        "resumed": t.preemptions > 0,
                        "wait_s": round(t.t_admit - t.t_submit, 6)})
                if self.registry:
                    self.registry.counter(
                        "serve_admissions_total",
                        "requests admitted into a device slot").inc()
        self._restore_held(held)
        return admitted

    def _retire_slot(self, s: int):
        t = self.active[s]
        self.active[s] = None
        t.t_done = self._now()
        t.req.done = True
        self.finished.append(t.req)
        self.finished_tickets.append(t)
        if self.tracer:
            self.tracer.instant("retire", {
                "rid": t.req.rid, "slot": s, "quanta": t.quanta,
                "preemptions": t.preemptions, "tokens": len(t.req.out),
                "latency_s": round(t.t_done - t.t_submit, 6)})
        if self.registry:
            self.registry.counter("serve_requests_finished_total",
                                  "requests retired complete").inc()
            self.registry.counter("serve_tokens_total",
                                  "committed progress units "
                                  "(tokens / moves)").inc(len(t.req.out))

    def _preempt_slot(self, s: int):
        """Requeue an over-budget request at the tail (round-robin sharing);
        generated tokens stay in ``req.out`` and are re-prefilled on
        re-admission, so nothing is lost."""
        t = self.active[s]
        self.active[s] = None
        t.preemptions += 1
        self.queue.append(t)
        if self.tracer:
            self.tracer.instant("preempt", {
                "rid": t.req.rid, "slot": s,
                "quanta_run": t.quanta - t.quanta_at_admit,
                "progress": len(t.req.out) - t.seg_base})
        if self.registry:
            self.registry.counter("serve_preemptions_total",
                                  "over-budget requests requeued").inc()

    def _waiting_for(self, t: Ticket) -> bool:
        """Would preempting ``t`` let queued work run?

        The flat-pool engines say yes whenever anything queues; engines
        with PARTITIONED slot pools (``repro_torch.serve.games`` keeps one pool
        per game class) narrow this to waiters that can actually use the
        freed slot — preempting for a stranger of another class would only
        idle the slot.
        """
        return bool(self.queue)

    def _should_preempt(self, t: Ticket, progressed: bool | None = None) -> bool:
        # progress guard: a segment is only preemptible once it has
        # committed a fresh token — otherwise a resumed request whose
        # context replay outlasts its quantum budget would be requeued
        # before ever reaching emission and livelock at zero progress
        if progressed is None:
            progressed = len(t.req.out) > t.seg_base
        return (self.preempt_quanta is not None
                and self.policy not in ("one_per_core", "sequential")
                and t.quanta - t.quanta_at_admit >= self.preempt_quanta
                and progressed
                and self._waiting_for(t))

    # -- resilience (DESIGN.md §17) ---------------------------------------
    def _backoff_ticks(self, retries: int) -> int:
        """Capped exponential backoff: min(base * 2**(k-1), cap) ticks."""
        return min(self.backoff_base << max(0, retries - 1),
                   self.backoff_cap)

    def _requeue_for_retry(self, t: Ticket, err: BaseException) -> None:
        """Tail-requeue a failed ticket with retry count + backoff gate.
        FIFO fairness is preserved: the ticket rejoins the queue like a
        preempted one, and the backoff gate holds its *admission*, not its
        queue position."""
        t.retries += 1
        t.not_before = self._ticks + self._backoff_ticks(t.retries)
        self.queue.append(t)
        if self.tracer:
            self.tracer.instant("retry", {
                "rid": t.req.rid, "retries": t.retries,
                "error": type(err).__name__,
                "not_before_tick": t.not_before})
        if self.registry:
            self.registry.counter(
                "serve_retries_total",
                "failed dispatches requeued for retry").inc()

    def _healthy_peers(self, slot_key) -> int:
        """Slots still in service in ``slot_key``'s pool (flat pool here;
        per-class engines narrow it)."""
        return self.B - len(self.quarantined)

    def _note_slot_ok(self, slot_key) -> None:
        self._slot_strikes.pop(slot_key, None)

    def _note_slot_failure(self, slot_key) -> bool:
        """Record a slot failure; quarantine the slot after
        ``quarantine_after`` CONSECUTIVE failures — unless it is the last
        healthy slot of its pool (the engine degrades gracefully on
        survivors; it never quarantines itself to a standstill)."""
        strikes = self._slot_strikes.get(slot_key, 0) + 1
        self._slot_strikes[slot_key] = strikes
        if (self.quarantine_after is None
                or strikes < self.quarantine_after
                or self._healthy_peers(slot_key) <= 1):
            return False
        self.quarantined.add(slot_key)
        self._slot_strikes.pop(slot_key, None)
        if self.tracer:
            self.tracer.instant("quarantine", {
                "slot": str(slot_key), "strikes": strikes})
        if self.registry:
            self.registry.counter(
                "serve_slots_quarantined_total",
                "slots removed from service after repeated failures").inc()
        return True

    def _record_injected(self, ev) -> None:
        """Telemetry for a fault event that actually fired."""
        self.injector.record_fired(ev)
        if self.tracer:
            self.tracer.instant("fault", {
                "kind": ev.kind, "slot": ev.slot, "tick": self._ticks})
        if self.registry:
            self.registry.counter(
                "serve_faults_injected_total",
                "fault-injector events that fired").inc()

    def _apply_driver_fault(self, ev) -> None:
        """Driver-level fault kinds, applied at the top of ``_tick``."""
        if ev.kind == "clock_stall":
            # the engine clock jumps forward by stall_s: every deadline
            # gets closer, queue waits inflate — a simulated GC pause
            self._t0 -= ev.stall_s
            self._record_injected(ev)
        elif ev.kind == "duplicate_submit":
            victims = ([t.req for t in self.active if t is not None]
                       + [t.req for t in self.queue])
            if victims:
                self._record_injected(ev)
                self.submit(victims[ev.slot % len(victims)])

    # -- grain accounting -------------------------------------------------
    def _work_estimate(self, t: Ticket) -> int:
        """Micro-steps this admission segment needs (engine-specific)."""
        raise NotImplementedError

    def _tick_m(self) -> int:
        """Micro-steps for this dispatch.

        ``fifo`` dispatches exactly the configured grain — slots whose plan
        boundary falls mid-dispatch just account for it (cutting every
        dispatch to the smallest pending quantum would let staggered
        arrivals fragment the grain to nothing). ``rebalance`` re-splits
        idle slots' lane budget over the active ones (larger quanta keep
        device work per dispatch constant — the serving analogue of the
        scheduler's no-idle-lanes re-split). ``one_per_core`` dispatches
        until the LONGEST active request completes: one monolithic task per
        lane, the paper's baseline — and its head-of-line pathology.
        """
        live = [t for t in self.active if t is not None]
        if self.policy in ("one_per_core", "sequential"):
            m = max(max(1, t.q_rem) for t in live)
        elif self.policy == "rebalance" and len(live) < self.B:
            m = math.ceil(self.grain * self.B / len(live))
        else:
            m = self.grain
        for t in live:
            t.q_rem -= m
            while t.q_rem <= 0:
                t.quanta += 1
                t.plan_idx += 1
                t.q_rem += (t.plan[t.plan_idx] if t.plan_idx < len(t.plan)
                            else self.grain)
        return m

    # -- engine interface -------------------------------------------------
    def _load_slot(self, s: int, t: Ticket):
        raise NotImplementedError

    def step(self) -> int:
        raise NotImplementedError

    # -- run loops --------------------------------------------------------
    def _tick(self):
        """One observed engine tick: step(), wrapped in a trace span when a
        tracer is attached, plus queue/slot gauge updates. With a
        ``FaultInjector`` attached, this is also the chaos boundary: the
        tick's planned events are armed here, driver-level kinds (clock
        stalls, duplicate submissions) applied immediately, slot-level
        kinds consumed by the engine around each slot's quantum."""
        if self.injector is not None:
            for ev in self.injector.begin_tick(self._ticks):
                self._apply_driver_fault(ev)
        if self.tracer:
            with self.tracer.span("tick", {"tick": self._ticks}):
                self.step()
            self.tracer.counter("queue", {
                "depth": len(self.queue),
                "active": sum(t is not None for t in self.active)})
            self.tracer.poll_compiles()
        else:
            self.step()
        if self.registry:
            self.registry.counter("serve_ticks_total",
                                  "engine ticks dispatched").inc()
            self.registry.gauge("serve_queue_depth",
                                "requests waiting").set(len(self.queue))
            self.registry.gauge("serve_active_slots",
                                "occupied device slots").set(
                sum(t is not None for t in self.active))
        self._ticks += 1

    def _check_exhausted(self, what: str, budget: int,
                         on_exhaust: str) -> None:
        """Tick budget ran out with work still pending: silent work loss is
        a hang in disguise, so the default is to raise with the unfinished
        rids (``on_exhaust="warn"`` downgrades to a RuntimeWarning,
        ``"ignore"`` is the deliberate early-stop escape hatch; either way
        ``stats().n_unfinished`` reports the leftovers)."""
        if not self.has_work() or on_exhaust == "ignore":
            return
        unfinished = ([t.req.rid for t in self.active if t is not None]
                      + [t.req.rid for t in self.queue])
        msg = (f"{what}={budget} exhausted with {len(unfinished)} request(s)"
               f" unfinished: {unfinished[:8]}"
               f"{'...' if len(unfinished) > 8 else ''} — raise the tick "
               "budget, or pass on_exhaust='warn'/'ignore' for a deliberate "
               "early stop")
        if on_exhaust == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
        else:
            raise RuntimeError(msg)

    def run(self, max_ticks: int = 10_000,
            on_exhaust: str = "raise") -> list:
        """Drain loop: tick until the queue and all slots are empty.

        ``max_ticks`` bounds THIS call (``self._ticks`` keeps the lifetime
        total for telemetry) so a long-lived engine can run repeatedly.
        Exhausting the budget with tickets still queued or active raises by
        default (see ``_check_exhausted``) — an engine that quietly returns
        with unserved work is indistinguishable from one that hung.
        """
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self._tick()
            ticks += 1
        self._check_exhausted("max_ticks", max_ticks, on_exhaust)
        return self.finished

    def run_trace(self, trace: list[tuple[float, Any]],
                  max_ticks: int = 1_000_000,
                  on_exhaust: str = "raise") -> list:
        """Replay an arrival trace of ``(arrival_s, request)`` against the
        wall clock (arrival_s relative to the call instant).

        Arrivals are offset to the current clock rather than re-seating the
        engine epoch, so timestamps of requests already submitted (and of
        earlier runs) stay valid in ``stats()``.
        """
        base = self._now()
        pending = collections.deque(
            sorted(((base + t, req) for t, req in trace), key=lambda p: p[0]))
        ticks = 0
        while (pending or self.has_work()) and ticks < max_ticks:
            now = self._now()
            while pending and pending[0][0] <= now:
                at, req = pending.popleft()
                self.submit(req, at=at)
            if self.has_work():
                self._tick()
                ticks += 1
            elif pending:
                time.sleep(min(pending[0][0] - now, 1e-3))
        self._check_exhausted("max_ticks", max_ticks, on_exhaust)
        return self.finished

    def stats(self) -> QueueStats:
        """Telemetry over every ticket the pool has seen: finished,
        still-active, and queued — so a mid-run (or never-finishing) serve
        still reports its preemptions, quanta, and committed progress."""
        live = [t for t in self.active if t is not None]
        return QueueStats.from_tickets(
            self.finished_tickets + live + list(self.queue),
            n_shed=len(self.shed), n_quarantined=len(self.quarantined),
            device_wait_s=self.device_wait_s)


# ------------------------------------------------------- LM half (A10) ----
def _refuse(name: str):
    raise NotImplementedError(
        f"{name}: the LM serving engines are not ported yet (ROADMAP.md item "
        "A10 (LM half)); board-game search serves through "
        "repro_torch.serve.games.TPFIFOGameEngine")


class LaneState:
    def __init__(self, *args, **kw):
        _refuse("LaneState")


def sample_tokens(*args, **kw):
    _refuse("sample_tokens")


def run_quantum(*args, **kw):
    _refuse("run_quantum")


def load_slot(*args, **kw):
    _refuse("load_slot")


def free_slot(*args, **kw):
    _refuse("free_slot")


def reset_slot_rows(*args, **kw):
    _refuse("reset_slot_rows")


class TPFIFOEngine(TPFIFODriver):
    def __init__(self, *args, **kw):
        _refuse("TPFIFOEngine")


class TPFIFOMCTSEngine(TPFIFODriver):
    def __init__(self, *args, **kw):
        _refuse("TPFIFOMCTSEngine")
