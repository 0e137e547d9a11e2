"""TPFIFO serving: a work-sharing FIFO request scheduler over device slots.

Port of ``repro.serve.tpfifo``. The paper's headline result is that a
plain FIFO work-sharing thread pool (TPFIFO) with controlled task grain
out-scales work-stealing runtimes for irregular MCTS workloads. This module
carries that scheduler to the serving layer: the *queue* holds requests,
the *workers* are the B fixed device slots of an engine, and the *task
grain* is ``m`` micro-steps (decode ticks, or MCTS commit rounds) per
dispatch.

- ``TPFIFODriver`` — the host-side pool: one FIFO queue of ``Ticket``s, B
  slots, per-request quantum plans derived from
  ``repro_torch.core.scheduler.quantum_plan`` (``fifo``/``rebalance`` slice
  requests into uniform grains, ``one_per_core`` runs each request to
  completion), tail-requeue preemption with a progress guard, retry with
  capped exponential backoff, slot quarantine, load shedding, and
  per-request telemetry summarized by ``QueueStats``. It is host code
  only and reads no tensor; ``repro_torch.serve.engine``'s lockstep
  engines subclass it with ``grain=None``, the engines below and
  ``repro_torch.serve.games.TPFIFOGameEngine`` with a real grain.

- ``TPFIFOEngine`` — grain-size-controlled continuous batching for LM
  decode. One quantum (``run_quantum``) advances ALL slots ``m``
  micro-steps; each micro-step feeds exactly one token per slot through
  ``api.decode`` at each slot's own cursor, so *prefill and decode share
  one step*: a slot still inside its context consumes the next context
  token (chunked prefill), a slot past it appends the token it just
  sampled. Shapes are fixed by ``(n_slots, max_len)`` and ``m`` is a
  run-time value: admissions, retirements, preemptions and grain changes
  build no kernel (the JAX package's "one compiled quantum").

- ``TPFIFOMCTSEngine`` — the search-guided sibling: a quantum is ``m``
  search+commit rounds of ``mcts_decode_search_batch`` over the fixed (B,
  max_prompt_len) token matrix.

Preemption is lossless: a preempted request keeps its generated tokens in
``Request.out``; on re-admission its context is ``prompt ⊕ out`` and the
chunked prefill recomputes the KV for the full context, so greedy decoding
resumes bit-identically.

Where the JAX package donates the lane state and the cache to the jitted
quantum, the port updates them in place: ``load_slot``, ``free_slot`` and
``reset_slot_rows`` write into the tensors they are given, ``run_quantum``
writes the cache and the token rows. Randomness is ``repro_torch.rng``
keys: the engine key is split once a tick, micro-step t samples with
``fold_in(tick key, t)``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import scheduler as sched
from repro_torch.models import api
from repro_torch.models.common import ModelConfig

# ------------------------------------------------------------------ queue ----
@dataclasses.dataclass
class Ticket:
    """Queue entry wrapping one request, with scheduling state + telemetry.

    ``req`` is duck-typed: ``TPFIFODriver`` itself needs only ``rid``, ``out``
    (a list that grows with committed progress — the preemption guard's
    currency), and ``done``. The LM engines additionally read ``prompt``/
    ``max_new`` (``repro_torch.serve.engine.Request``); the game-search
    engine reads its own fields (``repro_torch.serve.games.GameRequest``).
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


# ------------------------------------------------------------- LM quantum ----
class LaneState(NamedTuple):
    """Per-slot device state for the unified prefill/decode micro-step.

    tokens: (B, L) i32 context ⊕ generated; pos: (B,) next KV write
    position; in_tok: (B,) token to feed at pos; ctx_len: (B,) context
    length (prompt ⊕ resumed tokens); gen: (B,) tokens generated this
    segment; budget: (B,) segment generation budget; live: (B,) slot is
    occupied and unfinished (dead lanes are frozen, not skipped — the batch
    shape never changes). Tensors on the engine's device, updated in place
    by ``load_slot`` / ``free_slot`` and replaced field by field by
    ``run_quantum``.
    """
    tokens: torch.Tensor
    pos: torch.Tensor
    in_tok: torch.Tensor
    ctx_len: torch.Tensor
    gen: torch.Tensor
    budget: torch.Tensor
    live: torch.Tensor


def init_lane_state(n_slots: int, max_len: int, device=None) -> LaneState:
    """B empty lanes: no context, nothing live (``device=None``: CUDA)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return LaneState(
        tokens=torch.zeros((n_slots, max_len), **i32),
        pos=torch.zeros((n_slots,), **i32),
        in_tok=torch.zeros((n_slots,), **i32),
        ctx_len=torch.ones((n_slots,), **i32),
        gen=torch.zeros((n_slots,), **i32),
        budget=torch.zeros((n_slots,), **i32),
        live=torch.zeros((n_slots,), dtype=torch.bool, device=device))


def sample_tokens(logits: torch.Tensor, key: torch.Tensor,
                  temperature: float = 0.0) -> torch.Tensor:
    """(B, 1, V) -> (B, 1) int32: greedy (t = 0; the first maximal index,
    as ``jnp.argmax``) or temperature sampling.

    The sample is ``jax.random.categorical(key, logits / t)`` with ONE key
    for the whole batch: one Gumbel field of B·V values drawn from the key
    in row-major order (``rng.gumbel(key, B·V)``), not one (V,) vector
    broadcast over the rows, which is what ``rng.categorical`` on a single
    key would give. Lives here (not ``serve.engine``) so the lockstep
    engines and the quantum share one sampler; ``serve.engine`` re-exports
    it.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.to(torch.float32) / temperature
    field = rng.gumbel(key, scaled.numel()).view(scaled.shape)
    return torch.argmax(scaled + field, dim=-1).to(torch.int32)


def _sample(logits: torch.Tensor, key: torch.Tensor, temperature: float):
    """(B, 1, V) -> (B,) — the quantum's squeezed view of sample_tokens."""
    return sample_tokens(logits, key, temperature)[:, 0]


def run_quantum(params, state: LaneState, cache, key: torch.Tensor, m,
                eos_id, *, mcfg: ModelConfig, temperature: float):
    """One grain-sized work quantum: ``m`` micro-steps for ALL B slots.

    Each micro-step is one ``api.decode`` over the whole slot batch at each
    slot's own cursor. A slot still inside its context feeds the next
    context token (chunked prefill); a slot past its context feeds — and
    records — the token it just sampled (decode). Finished/empty lanes are
    frozen in place. ``m`` and ``eos_id`` are run-time values and shapes
    are fixed by ``(n_slots, max_len)``: where the JAX package compiles one
    program for every occupancy and grain, here no kernel is built after
    the first quantum (``kernels._build.builds``). The cache and
    ``state.tokens`` are written in place; returns (state, cache).
    """
    B, L = state.tokens.shape
    slot = torch.arange(B, device=state.tokens.device)
    st = state
    for t in range(int(m)):
        logits, cache = api.decode(params, mcfg, st.in_tok[:, None], st.pos,
                                   cache)
        # greedy sampling reads no key: skip micro-step t's fold_in (~120
        # threefry launches and a host-to-device copy of t)
        step_key = rng.fold_in(key, t) if temperature > 0.0 else key
        sampled = _sample(logits, step_key, temperature)
        new_pos = st.pos + 1
        # this step fed the last context token (or a generated one): its
        # logits produce a fresh token for the slot
        emitting = st.live & (new_pos >= st.ctx_len)
        wpos = torch.clamp(new_pos, max=L - 1).long()
        cur = st.tokens[slot, wpos]
        st.tokens[slot, wpos] = torch.where(emitting, sampled, cur)
        gen = st.gen + emitting.to(torch.int32)
        finished = emitting & ((sampled == eos_id) | (gen >= st.budget)
                               | (new_pos >= L - 1))
        st = LaneState(
            tokens=st.tokens,
            pos=torch.where(st.live, new_pos, st.pos),
            in_tok=torch.where(st.live, st.tokens[slot, wpos], st.in_tok),
            ctx_len=st.ctx_len,
            gen=gen,
            budget=st.budget,
            live=st.live & ~finished,
        )
    return st, cache


def load_slot(state: LaneState, s: int, row, ctx_len: int,
              budget: int) -> LaneState:
    """Admit one request into slot ``s`` IN PLACE: context row in (a (L,)
    host or device vector), cursor to 0, lane made live."""
    row = torch.as_tensor(row).to(device=state.tokens.device,
                                  dtype=torch.int32)
    state.tokens[s] = row
    state.pos[s] = 0
    state.in_tok[s] = row[0]
    state.ctx_len[s] = int(ctx_len)
    state.gen[s] = 0
    state.budget[s] = int(budget)
    state.live[s] = True
    return state


def free_slot(state: LaneState, s: int) -> LaneState:
    """Kill slot ``s``'s lane IN PLACE (preemption): the frozen lane stops
    burning micro-steps until an admission overwrites it."""
    state.live[s] = False
    return state


def reset_slot_rows(cache, mask, *, axes_def: tuple):
    """Zero the cache rows of admitted slots IN PLACE (mask: (B,) bool, on
    the host or the cache's device), along each leaf's batch axis
    (``axes_def``: the leaves' axes in ``api.cache_batch_axes``'s order).

    Attention KV rows are masked by position anyway, but recurrent-state
    leaves (ssm/xlstm families) are cumulative — a refilled slot must start
    its chunked re-prefill from a clean state.
    """
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    leaves = cache_leaves(cache)
    rows = torch.as_tensor(np.flatnonzero(np.asarray(mask, bool)),
                           device=leaves[0].device)
    for x, bi in zip(leaves, axes_def):
        x.index_fill_(bi, rows, 0)
    return cache


def cache_leaves(cache) -> list:
    """A cache tree's tensors ({stage: {k|v: tensor}}), in leaf order."""
    return [x for stage in cache.values() for x in stage.values()]


def cache_batch_axes(mcfg: ModelConfig, n_slots: int, max_len: int) -> tuple:
    """Each cache leaf's batch axis, in ``cache_leaves``' order."""
    return tuple(cache_leaves(api.cache_batch_axes(mcfg, n_slots, max_len)))


# ------------------------------------------------------------- LM engine ----
class TPFIFOEngine(TPFIFODriver):
    """Work-sharing FIFO LM server with grain-controlled continuous batching.

    B device slots over one KV cache; each tick dispatches ONE quantum of
    ``m`` unified prefill/decode micro-steps (``run_quantum``). Long
    prompts prefill in grain-sized chunks alongside other slots' decodes;
    finished slots refill from the queue at the next dispatch with no shape
    change; over-budget requests are preempted and requeued losslessly
    (``preempt_quanta``). ``device=None`` means CUDA; ``params`` must lie on
    the engine's device.
    """

    def __init__(self, params, cfg: ModelConfig, n_slots: int, max_len: int,
                 grain: int = 8, policy: str = "fifo",
                 preempt_quanta: int | None = None, temperature: float = 0.0,
                 eos_id: int = 2, seed: int = 0, tracer=None, registry=None,
                 device=None):
        super().__init__(n_slots, grain=grain, policy=policy,
                         preempt_quanta=preempt_quanta, tracer=tracer,
                         registry=registry)
        if tracer is not None:
            # no jit cache: the watch counts builds of the kernel library
            tracer.watch_compiles("run_quantum")
        self.device = (torch.device("cuda") if device is None
                       else torch.device(device))
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.key = rng.key(seed, self.device)

        self.cache = api.init_cache(cfg, n_slots, max_len, device=self.device)
        self._axes_def = cache_batch_axes(cfg, n_slots, max_len)
        # device-resident lane state: per tick the host pulls only the (B,)
        # live/gen vectors; token rows cross back only at retire/preempt
        # boundaries, so tick cost is one quantum + two small transfers
        # regardless of grain
        self._state = init_lane_state(n_slots, max_len, self.device)
        self._host_ctx_len = np.ones((n_slots,), np.int32)

    def submit(self, req, at: float | None = None) -> bool:
        if len(req.prompt) + req.max_new >= self.max_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new ({req.max_new}) "
                f"must stay below max_len ({self.max_len})")
        return super().submit(req, at=at)

    # -- TPFIFODriver hooks ----------------------------------------------
    def _work_estimate(self, t: Ticket) -> int:
        # context replay + remaining generation: emission starts on the
        # micro-step that feeds the LAST context token, so the total is
        # ctx_len + budget - 1, not ctx_len + budget. Invariant across
        # resumes: ctx grows by exactly the tokens the budget shrinks by.
        return len(t.req.prompt) + t.req.max_new - 1

    def _load_slot(self, s: int, t: Ticket):
        req = t.req
        ctx = np.asarray(list(req.prompt) + list(req.out), np.int32)
        row = np.zeros((self.max_len,), np.int32)
        row[:len(ctx)] = ctx
        self._host_ctx_len[s] = len(ctx)
        load_slot(self._state, s, torch.from_numpy(row), len(ctx),
                  req.max_new - len(req.out))

    def _sync_out(self, s: int, t: Ticket, gen: int):
        """Pull slot ``s``'s generated tokens into ``req.out`` (boundary
        crossings only: retire, preempt, or an explicit flush)."""
        pl = int(self._host_ctx_len[s])
        row = self._state.tokens[s].cpu().numpy()
        t.req.out[t.seg_base:] = row[pl:pl + gen].tolist()

    # -- tick -------------------------------------------------------------
    def step(self) -> int:
        admitted = self._admit_free_slots()
        if admitted:
            mask = np.zeros((self.B,), bool)
            mask[admitted] = True
            reset_slot_rows(self.cache, mask, axes_def=self._axes_def)
        if not any(t is not None for t in self.active):
            return 0
        m = self._tick_m()
        self.key, k = rng.split(self.key)
        self._state, self.cache = run_quantum(
            self.params, self._state, self.cache, k, m, self.eos_id,
            mcfg=self.cfg, temperature=self.temperature)
        # the tick's only mandatory readback: two (B,) vectors the
        # scheduler needs; token rows stay on the device until
        # retire/preempt
        with self._device_wait("lane_summary"):
            live = self._state.live.cpu().numpy()
            gen = self._state.gen.cpu().numpy()

        served = 0
        for s, t in enumerate(self.active):
            if t is None:
                continue
            served += 1
            if not live[s]:
                self._sync_out(s, t, int(gen[s]))
                self._retire_slot(s)
            elif self._should_preempt(t, progressed=bool(gen[s] > 0)):
                self._sync_out(s, t, int(gen[s]))
                free_slot(self._state, s)
                self._preempt_slot(s)
        return served


# ----------------------------------------------------------- MCTS engine ----
class TPFIFOMCTSEngine(TPFIFODriver):
    """TPFIFO over search-guided decoding: a quantum is ``m`` search+commit
    rounds of ``mcts_decode_search_batch`` (each round advances all slots'
    trees as one forest). Admission, preemption, and requeue happen only at
    quantum boundaries — the grain dial trades scheduling responsiveness
    against per-round host dispatch, exactly the paper's Table I axis.
    ``device=None`` means CUDA; ``params`` must lie on the engine's device.
    """

    def __init__(self, params, cfg: ModelConfig, dcfg, n_slots: int,
                 max_prompt_len: int, grain: int = 4, policy: str = "fifo",
                 preempt_quanta: int | None = None, eos_id: int = 2,
                 seed: int = 0, tracer=None, registry=None, device=None):
        super().__init__(n_slots, grain=grain, policy=policy,
                         preempt_quanta=preempt_quanta, tracer=tracer,
                         registry=registry)
        self.device = (torch.device("cuda") if device is None
                       else torch.device(device))
        self.params = params
        self.cfg = cfg
        self.dcfg = dcfg
        self.max_prompt_len = max_prompt_len
        self.eos_id = eos_id
        self.key = rng.key(seed, self.device)
        self.tokens = np.zeros((n_slots, max_prompt_len), np.int32)
        self.lens = np.ones((n_slots,), np.int32)
        self._done = np.zeros((n_slots,), bool)
        self.search_stats: collections.deque = collections.deque(maxlen=256)

    def submit(self, req, at: float | None = None) -> bool:
        if len(req.prompt) + req.max_new > self.max_prompt_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new ({req.max_new}) "
                f"exceeds max_prompt_len ({self.max_prompt_len})")
        return super().submit(req, at=at)

    def _work_estimate(self, t: Ticket) -> int:
        return t.req.max_new - len(t.req.out)     # commit rounds remaining

    def _load_slot(self, s: int, t: Ticket):
        req = t.req
        ctx = np.asarray(list(req.prompt) + list(req.out), np.int32)
        L = len(ctx)
        self.tokens[s, :] = 0
        self.tokens[s, :L] = ctx
        self.lens[s] = L
        self._done[s] = False

    def step(self) -> int:
        from repro_torch.serve.mcts_decode import mcts_decode_search_batch

        self._admit_free_slots()
        if not any(t is not None for t in self.active):
            return 0
        m = self._tick_m()
        served = 0
        for _ in range(m):
            mask = np.array([t is not None for t in self.active]) & ~self._done
            if not mask.any():
                break           # grain tail after every slot finished
            served = max(served, int(mask.sum()))
            self.key, k = rng.split(self.key)
            _, stats = mcts_decode_search_batch(
                self.params, self.cfg, self.tokens, self.dcfg, k,
                prompt_lens=self.lens, request_mask=mask, device=self.device)
            self.search_stats.append(stats)
            for s, t in enumerate(self.active):
                if t is None or self._done[s]:
                    continue
                tok = int(stats["best_tokens"][s])
                t.req.out.append(tok)
                self.tokens[s, self.lens[s]] = tok
                self.lens[s] += 1
                if (tok == self.eos_id or len(t.req.out) >= t.req.max_new
                        or self.lens[s] >= self.max_prompt_len):
                    self._done[s] = True
        for s, t in enumerate(self.active):
            if t is None:
                continue
            if self._done[s]:
                self._retire_slot(s)
            elif self._should_preempt(t):
                self._preempt_slot(s)
        return served
