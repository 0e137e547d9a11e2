"""Multi-tenant game-search serving: ``Game`` requests through the TPFIFO
quantum engine (port of ``repro.serve.games``; DESIGN.md §14).

The paper's FIFO work-sharing pool schedules one search's task queue;
this module is the same scheduler serving *strangers' games*. Board-game
search requests (hex, gomoku, any ``Game``-registry entry) queue in the
host-side TPFIFO and are served in work quanta of ``m`` GSC-PM schedule
rounds each — the batched descent + fused playout machinery of
``core/gscpm``, dispatched through ``run_schedule_round``, exactly the
calls an uninterrupted ``gscpm_search`` would make.

Layout:

- one FIFO queue for ALL traffic, but a fixed slot pool **per game
  class**. A game class is the request's ``GSCPMConfig`` — games hash by
  type (``stamp_game_identity``) and the budget knobs (``n_playouts``,
  ``n_tasks``, ``cp``, inner scheduler) are ``compare=False``, so
  per-request budget/Cp/grain churn never opens a second pool. The port
  runs eagerly and has no jit cache: the "no recompile" contract is that no
  build of the kernel library happens after the first request
  (``obsv.trace.kernel_builds``).
- per-request budgets: ``n_playouts``/``n_tasks`` fix the request's round
  schedule (``core/scheduler.make_schedule``), ``cp`` is a run-time value
  of the quantum, and ``deadline_s`` is a
  time-to-move deadline — an expired request retires immediately with
  whatever root statistics its tree holds (``core/tree.root_summary``),
  never a crash, never a poisoned slot.
- tail-requeue preemption reuses ``core/scheduler.quantum_plan`` and the
  progress guard (≥1 committed round per admission segment, and only
  when a SAME-class request waits — a freed hex slot cannot serve a
  queued gomoku). A preempted request's device-resident tree rides along
  in the engine's state table, so resumption continues the identical
  round sequence: a quantum-served search is **bit-identical** to the
  same search run uninterrupted. That contract is this module's center of
  gravity.

Where the port differs in idiom from the JAX package:

- Trees are updated IN PLACE by the search (``core.gscpm``), where JAX
  donates them. A session's tree is checked out to the engine and written
  into by the warm search; nothing else may hold it meanwhile. A caller
  that wants the old state (a reference search in a test) clones it.
- Pipelined retirement on one CUDA stream: the retirement summary is
  copied into pinned host tensors with ``non_blocking=True`` and a
  ``torch.cuda.Event`` is recorded behind the copy; a tick later the host
  waits on that event only (inside ``_device_wait("retire_summary")``),
  not on the stream, which by then also holds this tick's quanta. On the
  CPU the summary is a plain copy.
- ``device=None`` means ``torch.device("cuda")``; tests pass ``"cpu"``.
  Forest tenants run on one device: ``ensemble_mesh()`` is None there and
  raises on more than one (ROADMAP.md A7's multi-card row), as in the JAX
  package's one-device arm.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import game as game_mod
from repro_torch.core import scheduler as sched
from repro_torch.core.gscpm import (GSCPMConfig, fold_task_keys,
                                    run_schedule_round, warm_tree_check)
from repro_torch.core.root_parallel import (ensemble_mesh, ensemble_sharding,
                                            forest_retire_summary,
                                            materialize_forest_summary,
                                            pad_forest_members,
                                            run_schedule_round_forest)
from repro_torch.core.tree import (Tree, init_forest, init_tree,
                                   materialize_root_summary, reroot_tree,
                                   root_summary_device)
from repro_torch.obsv.search_metrics import (init_search_metrics,
                                             init_search_metrics_forest,
                                             summarize_metrics)
from repro_torch.serve import resilience
from repro_torch.serve.resilience import InjectedFaultError, ResultGuardError
from repro_torch.serve.tpfifo import Ticket, TPFIFODriver


# ---------------------------------------------------------------- request ----
@dataclasses.dataclass
class GameRequest:
    """One search-a-move request against a registered ``Game``.

    Duck-typed for ``TPFIFODriver``'s ``Ticket`` (``rid``/``out``/``done``):
    ``out`` records completed schedule rounds — the progress-guard and
    telemetry currency, the serving twin of an LM request's generated
    tokens. ``board`` is an optional ``(n_cells,)`` int8 position (None =
    the empty board); ``deadline_s`` is the time-to-move budget measured
    from submission. The answer lands in ``result``: the
    ``core/tree.root_summary`` snapshot plus serving metadata.
    """

    rid: Any
    game: str = "hex"
    board_size: int = 9
    to_move: int = 1
    n_playouts: int = 512
    n_tasks: int = 16
    cp: float = 1.0
    seed: int = 0
    deadline_s: float | None = None
    board: Any = None
    # root-parallel ensemble width: E > 1 serves the request as a FOREST
    # tenant — E independent trees on the request's position, advanced by
    # one dispatch per round (on one device: the port's multi-card arm is
    # ROADMAP.md A7's) and retired with merged root stats
    # (``root_parallel.forest_root_summary``). ``n_playouts`` is the
    # PER-MEMBER budget; ``result["playouts"]`` reports the ensemble
    # total. Forest requests are stateless (no ``session``).
    n_trees: int = 1
    # the stateful tenant this request belongs to (``GameSession``): the
    # session's device-resident tree warm-starts the search and the final
    # tree is handed back at retirement. None = the classic stateless
    # search-a-position request.
    session: Any = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    result: dict | None = None


@dataclasses.dataclass
class _SearchState:
    """Device-side search of one admitted request.

    Survives preemption (the tree stays device-resident in the engine's
    state table while the ticket waits at the queue tail), which is what
    makes resumption literally a continuation of the same round sequence —
    nothing is replayed, nothing is lost.
    """

    cfg: GSCPMConfig
    board: torch.Tensor
    key: torch.Tensor
    cp: float
    schedule: list[sched.Round]
    tree: Tree
    round_idx: int = 0
    playouts: int = 0
    deadline: float | None = None   # absolute engine-clock instant
    expired: bool = False
    metrics: Any = None             # SearchMetrics accumulator (cfg.metrics)
    session: Any = None             # owning GameSession (tree returns to it)
    reused_nodes: int = 0           # warm-start inheritance (beyond the root)
    reused_visits: float = 0.0      # root evidence the search started from
    snap: Any = None                # last committed SearchSnapshot (chaos)
    # forest tenants (n_trees > 1): ``tree`` is an E-member forest (padded
    # to ``n_padded`` rows when an ensemble mesh does not divide E — never
    # on one device), ``board`` is the (n_padded, n_cells) tiled position,
    # and rounds dispatch ``run_schedule_round_forest`` with these member
    # streams
    n_trees: int = 1
    n_padded: int = 1
    member_keys: Any = None         # (n_padded, 2) member key streams
    mesh: Any = None                # ensemble mesh (None on one device)


def warm_budget(n_playouts: int, n_tasks: int, n_workers: int,
                retained_visits: float) -> tuple[int, int]:
    """Equal-evidence budget for a warm-started search (DESIGN.md §16).

    ``n_playouts`` is the TOTAL root evidence the move decision should rest
    on; a warm tree already holds ``retained_visits`` of it, so the search
    only runs the remainder (floored at one full worker batch so a fully
    warm position still refreshes its statistics). The task count shrinks
    proportionally — the grain ``m = n_playouts // n_tasks`` is preserved,
    so warm and cold searches run the SAME quantum program with the same
    per-round shape, just fewer rounds. This is the honest accounting
    behind "warm beats cold at equal playout budget": warm moves are
    faster because they run fewer fresh playouts for the same evidence,
    not because a playout got cheaper.
    """
    m = max(1, n_playouts // max(1, n_tasks))
    eff = max(n_workers, n_playouts - int(retained_visits))
    return eff, max(1, eff // m)


# ----------------------------------------------------------------- engine ----
class TPFIFOGameEngine(TPFIFODriver):
    """Work-sharing FIFO server for board-game search.

    ``n_slots`` is the slot-pool width PER GAME CLASS (pools materialize
    lazily as classes appear in traffic); ``grain`` is the quantum size in
    GSC-PM schedule rounds; ``policy``/``preempt_quanta`` are the
    TPFIFO disciplines. Engine-level knobs that shape the search's tensors
    (``n_workers``, ``tree_cap``, ``vl_rounds``, ``select_noise``) are
    fixed per engine; everything per-request (budget, grain, Cp, deadline,
    position, seed) is host-side and opens no new pool. ``device`` is where
    every tree lives (None: ``torch.device("cuda")``).

    ``metrics=True`` turns on the device-plane ``SearchMetrics`` plane for
    every served search (DESIGN.md §15): each request's accumulator rides
    its quanta (surviving preemption alongside the tree) and lands in
    ``result["metrics"]`` at retirement. It is a HASHED config field, so a
    metrics engine's game classes are pools of their own — results stay
    bit-identical. ``tracer``/``registry`` enable the host plane (see
    ``TPFIFODriver``), adding per-quantum ``X`` spans annotated with the
    round/iteration work they covered — the spans
    ``repro_torch.obsv.profile`` fits burden terms from — plus
    deadline-expiry instants and device-sync spans at retirement.
    """

    def __init__(self, n_slots: int = 2, grain: int = 2,
                 policy: str = "fifo", preempt_quanta: int | None = None,
                 n_workers: int = 8, vl_rounds: int = 1,
                 tree_cap: int = 1 << 12, select_noise: float = 1e-3,
                 inner_scheduler: str = "fifo", metrics: bool = False,
                 max_queue: int | None = None,
                 quarantine_after: int | None = None,
                 injector=None, retry_backoff: tuple[int, int] = (1, 8),
                 guard: bool = True, snapshots: bool | None = None,
                 pipeline: bool | None = None,
                 tracer=None, registry=None, device=None):
        super().__init__(n_slots, grain=grain, policy=policy,
                         preempt_quanta=preempt_quanta,
                         max_queue=max_queue,
                         quarantine_after=quarantine_after,
                         injector=injector, retry_backoff=retry_backoff,
                         tracer=tracer, registry=registry)
        # the result guard runs on every retirement; snapshots (needed to
        # retry from the last committed round instead of round 0) default
        # to on exactly when an injector is attached — a no-chaos engine
        # pays zero copy cost
        self.guard = guard
        self._snapshots = (injector is not None) if snapshots is None \
            else bool(snapshots)
        self.device = (torch.device("cuda") if device is None
                       else torch.device(device))
        # async round pipelining (DESIGN.md §18): a finished search frees
        # its slot immediately and its retirement readback is deferred one
        # tick, so the host materializes it WHILE the device runs the next
        # tick's quanta — no device readback on the hot tick path at all.
        # Pipelining needs that path sync-free, so it disables cleanly
        # whenever something must block per quantum: a tracer (honest span
        # durations), a fault injector, or snapshot commit points. The
        # served results are bit-identical either way;
        # ``self.pipeline`` reports the EFFECTIVE mode.
        want = True if pipeline is None else bool(pipeline)
        self.pipeline = (want and tracer is None and injector is None
                         and not self._snapshots)
        # deferred retirements: (class, slot, ticket, state, staged
        # summary, its copy's event or None)
        self._pending_retire: list[tuple] = []
        self.slots_per_class = n_slots
        self.template = GSCPMConfig(
            n_workers=n_workers, vl_rounds=vl_rounds, tree_cap=tree_cap,
            select_noise=select_noise, scheduler=inner_scheduler,
            metrics=metrics)
        if tracer is not None:
            # no jit cache in the port: the watch counts builds of the
            # kernels' library (obsv.trace.kernel_builds), the only thing
            # that can stall a quantum the way a compile does
            tracer.watch_compiles("run_chunk")
        # one slot pool per game class; self.active/self.B mirror the
        # flattened pools so the base driver's has_work/_tick_m accounting
        # (quantum plans, rebalance widening) applies unchanged
        self.pools: dict[GSCPMConfig, list[Ticket | None]] = {}
        self._states: dict[Any, _SearchState] = {}
        self.active = []
        self.B = 0

    # -- game classes -----------------------------------------------------
    def request_cfg(self, req: GameRequest) -> GSCPMConfig:
        """The request's full search config — also its game-class key.

        ``GSCPMConfig`` hashes/compares only by program-shaping fields
        (game, board_size, n_workers, tree_cap, ...): budget knobs are
        ``compare=False``, so requests differing only in
        n_playouts/n_tasks/cp/scheduler land in ONE pool. Tests build their
        uninterrupted reference searches from this same config.
        """
        return dataclasses.replace(
            self.template, game=req.game, board_size=req.board_size,
            n_playouts=req.n_playouts, n_tasks=req.n_tasks, cp=req.cp,
            n_trees=getattr(req, "n_trees", 1))

    def _sync_active(self) -> None:
        self.active = [t for pool in self.pools.values() for t in pool]
        self.B = self.slots_per_class * max(1, len(self.pools))

    # -- queue ------------------------------------------------------------
    def submit(self, req: GameRequest, at: float | None = None) -> bool:
        """Admission with full request validation (DESIGN.md §17).

        Malformed requests fail HERE with a typed error naming the field,
        not three quanta later as a shape error that poisons a slot.
        Returns True if queued; False if deduplicated (rid already
        pending) or shed (class queue at ``max_queue`` — the request
        retires immediately with ``status="shed"``).
        """
        cfg = self.request_cfg(req)
        game = cfg.game_obj        # raises for unregistered game names
        if isinstance(req.n_playouts, bool) or not isinstance(
                req.n_playouts, (int, np.integer)) or req.n_playouts < 1:
            raise ValueError(
                f"n_playouts must be a positive int, got {req.n_playouts!r}")
        if isinstance(req.n_tasks, bool) or not isinstance(
                req.n_tasks, (int, np.integer)) or req.n_tasks < 1:
            raise ValueError(
                f"n_tasks must be a positive int, got {req.n_tasks!r}")
        if req.to_move not in (1, 2):
            raise ValueError(f"to_move must be 1 or 2, got {req.to_move!r}")
        n_trees = getattr(req, "n_trees", 1)
        if isinstance(n_trees, bool) or not isinstance(
                n_trees, (int, np.integer)) or n_trees < 1:
            raise ValueError(
                f"n_trees must be a positive int, got {n_trees!r}")
        if n_trees > 1 and req.session is not None:
            raise ValueError(
                "forest requests (n_trees > 1) are stateless: sessions "
                "re-root ONE tree across moves (use reroot_forest + "
                "gscpm_search_batch(forest=...) for warm forests)")
        try:
            cp = float(req.cp)
        except (TypeError, ValueError):
            raise TypeError(
                f"cp must be a real number, got {type(req.cp).__name__}")
        if not math.isfinite(cp) or cp < 0:
            raise ValueError(f"cp must be finite and >= 0, got {req.cp!r}")
        if req.deadline_s is not None:
            try:
                dl = float(req.deadline_s)
            except (TypeError, ValueError):
                raise TypeError(f"deadline_s must be a real number or None, "
                                f"got {type(req.deadline_s).__name__}")
            if not math.isfinite(dl) or dl < 0:
                raise ValueError(
                    f"deadline_s must be finite and >= 0, "
                    f"got {req.deadline_s!r}")
        if req.board is not None:
            b = np.asarray(req.board)
            if b.dtype.kind not in "iu":
                raise TypeError(
                    f"board dtype must be integer (int8 positions), "
                    f"got {b.dtype}")
            if b.shape != (game.n_cells,):
                raise ValueError(
                    f"board shape {b.shape} != ({game.n_cells},); {req.game} "
                    f"{req.board_size}x{req.board_size} needs a flat "
                    f"({game.n_cells},) array")
            if not np.isin(b, (0, 1, 2)).all():
                raise ValueError(
                    "board cells must be 0 (empty), 1, or 2")
        return super().submit(req, at=at)

    def _queue_load(self, req: GameRequest) -> int:
        """Shedding is per game class: one game's burst fills only its own
        admission budget, it cannot starve another game's queue."""
        ck = self.request_cfg(req)
        return sum(1 for t in self.queue if self.request_cfg(t.req) == ck)

    def _healthy_peers(self, slot_key: tuple[GSCPMConfig, int]) -> int:
        ck, _ = slot_key
        return sum(1 for i in range(self.slots_per_class)
                   if (ck, i) not in self.quarantined)

    # -- TPFIFODriver hooks ----------------------------------------------
    def _work_estimate(self, t: Ticket) -> int:
        st = self._states[t.req.rid]
        return max(1, len(st.schedule) - st.round_idx)

    def _waiting_for(self, t: Ticket) -> bool:
        # slots are partitioned by class: preempting only helps a queued
        # request that can occupy the freed slot
        ck = self.request_cfg(t.req)
        return any(self.request_cfg(q.req) == ck for q in self.queue)

    def _admit_free_slots(self) -> list[tuple[GSCPMConfig, int]]:
        """FIFO admission against per-class pools.

        The queue is scanned in submission order; a request whose class
        pool is full stays queued (later requests of the SAME class cannot
        overtake it — its pool stays full for them too), while requests of
        other classes may pass (per-class pools exist precisely so one
        game's burst cannot head-of-line-block another's).
        """
        admitted: list[tuple[GSCPMConfig, int]] = []
        skipped: collections.deque[Ticket] = collections.deque()
        while self.queue:
            t = self.queue.popleft()
            if t.not_before > self._ticks:      # retry backoff gate
                skipped.append(t)
                continue
            ck = self.request_cfg(t.req)
            pool = self.pools.setdefault(ck, [None] * self.slots_per_class)
            s = next((i for i, x in enumerate(pool)
                      if x is None and (ck, i) not in self.quarantined),
                     None)
            if s is None:                       # pool full or quarantined
                skipped.append(t)
                continue
            if t.req.rid not in self._states:
                st = self._make_state(ck, t)
                if self._snapshots:
                    # round-0 commit point: a fault before the first
                    # quantum completes rolls back HERE (preserving a warm
                    # session tree) instead of rebuilding from scratch
                    with self._device_wait("snapshot", rid=t.req.rid):
                        st.snap = resilience.snapshot_search(
                            st.tree, st.metrics, 0, 0, len(t.req.out))
                self._states[t.req.rid] = st
            if t.t_admit is None:
                t.t_admit = self._now()
            t.quanta_at_admit = t.quanta
            t.seg_base = len(t.req.out)
            t.plan = sched.quantum_plan(self._work_estimate(t), self.grain,
                                        self.policy)
            t.plan_idx = 0
            t.q_rem = t.plan[0]
            pool[s] = t
            self.admission_order.append(t.req.rid)
            admitted.append((ck, s))
            if self.tracer:
                self.tracer.instant("admission", {
                    "rid": t.req.rid, "game": ck.game, "slot": s,
                    "resumed": t.preemptions > 0,
                    "wait_s": round(t.t_admit - t.t_submit, 6)})
            if self.registry:
                self.registry.counter(
                    "serve_admissions_total",
                    "requests admitted into a device slot").inc()
        self.queue = skipped
        self._sync_active()
        return admitted

    def _make_state(self, cfg: GSCPMConfig, t: Ticket) -> _SearchState:
        req = t.req
        game = cfg.game_obj
        # a copy: the caller's array is never aliased by a CPU tensor
        board = (game.init_board(self.device) if req.board is None
                 else torch.tensor(np.asarray(req.board), dtype=torch.int8,
                                   device=self.device))
        if cfg.n_trees > 1:
            return self._make_forest_state(cfg, t, board)
        # warm start: a session-backed request checks its tenant's
        # device-resident tree out of the session (ownership moves to the
        # engine until retirement, and the search writes into it) and
        # shrinks the budget by the evidence the tree already holds — same
        # class key, same pool, fewer rounds (``warm_budget``)
        tree = None
        reused_nodes = 0
        reused_visits = 0.0
        sess = req.session
        if sess is not None:
            tree = sess._checkout()
        if tree is not None:
            tree = Tree(*(x.to(self.device) for x in tree))
            warm_tree_check(tree, req.to_move, cfg)
            reused_nodes = int(tree.n_nodes) - 1
            reused_visits = float(tree.visits[0])
            eff_po, eff_tasks = warm_budget(
                cfg.n_playouts, cfg.n_tasks, cfg.n_workers, reused_visits)
            # compare=False fields: the replaced cfg hashes identically, so
            # the pool key is untouched
            cfg = dataclasses.replace(cfg, n_playouts=eff_po,
                                      n_tasks=eff_tasks)
        else:
            tree = init_tree(cfg.tree_cap, game.n_actions, req.to_move,
                             device=self.device)
        metrics = None
        if cfg.metrics:
            metrics = init_search_metrics(tree_nodes_reused=reused_nodes,
                                          device=self.device)
        return _SearchState(
            cfg=cfg, board=board, key=rng.key(req.seed, self.device),
            cp=float(cfg.cp),
            schedule=sched.make_schedule(cfg.n_playouts, cfg.n_tasks,
                                         cfg.n_workers, cfg.scheduler),
            tree=tree,
            deadline=(None if req.deadline_s is None
                      else t.t_submit + req.deadline_s),
            metrics=metrics, session=sess,
            reused_nodes=reused_nodes, reused_visits=reused_visits)

    def _make_forest_state(self, cfg: GSCPMConfig, t: Ticket,
                           board: torch.Tensor) -> _SearchState:
        """State for a forest tenant: E member trees on one position. The
        ensemble axis would be sharded over a device mesh, padded with
        bitwise-inert members; on one device ``ensemble_sharding`` gives
        no sharding and no pad (more devices raise: ROADMAP.md A7's
        multi-card row). Per-member RNG streams are the
        ``gscpm_search_batch`` folding of the request seed, so a
        quantum-served forest is bit-identical to the uninterrupted batch
        search."""
        req = t.req
        E = cfg.n_trees
        mesh = ensemble_mesh()
        _, Ep = ensemble_sharding(E, mesh)
        forest = init_forest(E, cfg.tree_cap, cfg.game_obj.n_actions,
                             req.to_move, device=self.device)
        boards = board[None, :].expand(E, -1).contiguous()
        forest, boards = pad_forest_members(forest, boards, Ep, cfg,
                                            req.to_move)
        key = rng.key(req.seed, self.device)
        member_keys = fold_task_keys(
            key, torch.arange(Ep, dtype=torch.int32, device=self.device))
        metrics = None
        if cfg.metrics:
            metrics = init_search_metrics_forest(Ep, self.device)
        return _SearchState(
            cfg=cfg, board=boards, key=key,
            cp=float(cfg.cp),
            schedule=sched.make_schedule(cfg.n_playouts, cfg.n_tasks,
                                         cfg.n_workers, cfg.scheduler),
            tree=forest,
            deadline=(None if req.deadline_s is None
                      else t.t_submit + req.deadline_s),
            metrics=metrics, n_trees=E, n_padded=Ep,
            member_keys=member_keys, mesh=mesh)

    # -- tick -------------------------------------------------------------
    def step(self) -> int:
        """One engine tick, double-buffered when ``self.pipeline``.

        The hot path — admission, quantum planning, round dispatch,
        retirement DETECTION (``round_idx``/``schedule`` are host state) —
        touches no device buffer. Retirements deferred by EARLIER ticks are
        materialized last, after this tick's quanta are already in flight,
        so their host readbacks overlap the device work instead of
        serializing with it (DESIGN.md §18). With pipelining off, ``ready``
        is always empty and ``_retire`` blocks inline as before.
        """
        ready, self._pending_retire = self._pending_retire, []
        self._admit_free_slots()
        live = [(ck, s, t) for ck, pool in self.pools.items()
                for s, t in enumerate(pool) if t is not None]
        if live:
            m = self._tick_m()
            failed: set = set()
            for ck, s, t in live:
                # fault containment boundary: a quantum that raises
                # (injected dispatch error, device loss, anything) is
                # contained to ITS slot — the search rolls back to its last
                # committed snapshot and requeues with backoff, the slot
                # takes a quarantine strike, and every other slot's quantum
                # still runs
                try:
                    self._run_slot(t, m, slot_key=(ck, s))
                except Exception as err:  # noqa: BLE001 — containment seam
                    self._fail_slot(ck, s, t, err)
                    failed.add(t.req.rid)
                else:
                    self._note_slot_ok((ck, s))
            for ck, s, t in live:
                if t.req.rid in failed:
                    continue
                st = self._states[t.req.rid]
                if st.expired or st.round_idx >= len(st.schedule):
                    self._retire(ck, s, t)
                elif self._should_preempt(t):
                    self._preempt(ck, s, t)
            self._sync_active()
        for ck, s, t, st, dev, copied in ready:
            with self._device_wait("retire_summary", rid=t.req.rid):
                if copied is not None:
                    copied.synchronize()
                self._materialize_retirement(ck, s, t, st, dev)
        return len(live)

    def has_work(self) -> bool:
        # deferred retirements are still work: run() must not exit (and
        # run_trace must not sleep past) requests awaiting materialization
        return bool(self._pending_retire) or super().has_work()

    def _is_pending(self, rid) -> bool:
        # a deferred retirement still owns its rid: a duplicate submitted
        # inside the one-tick materialization window must not double-serve
        return (super()._is_pending(rid)
                or any(p[2].req.rid == rid for p in self._pending_retire))

    def _flat_slot(self, slot_key: tuple[GSCPMConfig, int]) -> int:
        """Flatten a (class, slot) key to the injector's slot index space
        (pool insertion order × slots_per_class + slot)."""
        ck, s = slot_key
        return list(self.pools).index(ck) * self.slots_per_class + s

    def _sync(self) -> None:
        """Wait for the device's queued work (the tracer's honest spans)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage_summary(self, dev: dict):
        """Pipelined retirement: (host summary, event or None).

        On the card each summary tensor is copied into a fresh pinned host
        tensor with ``non_blocking=True`` and an event is recorded behind
        the copies: waiting on that event later waits for this summary
        only, not for the quanta queued after it (a ``.cpu()`` a tick later
        would wait for the whole stream). On the CPU it is a plain copy
        (``tree_nodes`` is the tree's own counter, updated in place).
        """
        if self.device.type != "cuda":
            return {k: v.clone() for k, v in dev.items()}, None
        host = {k: torch.empty(v.shape, dtype=v.dtype,
                               pin_memory=True).copy_(v, non_blocking=True)
                for k, v in dev.items()}
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    def _run_slot(self, t: Ticket, m: int,
                  slot_key: tuple[GSCPMConfig, int] | None = None) -> None:
        """One quantum: up to ``m`` schedule rounds of this request's
        search — the exact ``run_schedule_round`` calls (same key, same
        Round sequence) the uninterrupted driver would make, which is the
        whole bit-identity argument. With a tracer the quantum is recorded
        as an ``X`` span annotated with the rounds/iterations it actually
        covered (synchronising the device at span end so the duration is
        honest — a profiling perturbation, documented in DESIGN.md §15)."""
        st = self._states[t.req.rid]
        if self.injector is not None and slot_key is not None:
            ev = self.injector.dispatch_fault(self._flat_slot(slot_key))
            if ev is not None:
                self._record_injected(ev)
                raise InjectedFaultError(
                    f"injected dispatch failure: tick {self._ticks}, "
                    f"slot {self._flat_slot(slot_key)}, rid {t.req.rid}")
        span_args = {"rid": t.req.rid, "game": st.cfg.game, "rounds": 0,
                     "iterations": 0, "lane_iterations": 0,
                     "workers": st.cfg.n_workers} if self.tracer else None
        span = (self.tracer.span("quantum", span_args) if self.tracer
                else contextlib.nullcontext())
        with span:
            for _ in range(m):
                if st.round_idx >= len(st.schedule):
                    break
                if st.deadline is not None and self._now() >= st.deadline:
                    st.expired = True
                    if self.tracer:
                        self.tracer.instant("deadline_expiry", {
                            "rid": t.req.rid, "game": st.cfg.game,
                            "rounds_done": st.round_idx,
                            "rounds_total": len(st.schedule)})
                    if self.registry:
                        self.registry.counter(
                            "serve_deadline_expiries_total",
                            "searches retired on deadline").inc()
                    break
                rnd = st.schedule[st.round_idx]
                if st.n_trees > 1:
                    # root-parallel forest tenant: every member runs the
                    # SAME Round under its own folded key stream, all
                    # members in one pass (pad members run all-inactive)
                    if st.cfg.metrics:
                        st.tree, st.metrics = run_schedule_round_forest(
                            st.tree, st.board, st.cfg, st.member_keys, rnd,
                            st.cp, st.metrics, n_real=st.n_trees,
                            mesh=st.mesh)
                    else:
                        st.tree = run_schedule_round_forest(
                            st.tree, st.board, st.cfg, st.member_keys, rnd,
                            st.cp, n_real=st.n_trees, mesh=st.mesh)
                elif st.cfg.metrics:
                    st.tree, st.metrics = run_schedule_round(
                        st.tree, st.board, st.cfg, st.key, rnd, st.cp,
                        st.metrics)
                else:
                    st.tree = run_schedule_round(st.tree, st.board, st.cfg,
                                                 st.key, rnd, st.cp)
                st.round_idx += 1
                # a forest request's budget is per member; the conservation
                # guard checks the ENSEMBLE total, so count all members
                st.playouts += st.n_trees * int(rnd.active.sum()) * rnd.m
                t.req.out.append(st.round_idx)   # committed progress
                if span_args is not None:
                    span_args["rounds"] += 1
                    span_args["iterations"] += int(rnd.m)
                    span_args["lane_iterations"] += (
                        int(rnd.active.sum()) * rnd.m)
            if self.tracer and span_args["rounds"] > 0:
                with self._device_wait("quantum_sync", rid=t.req.rid):
                    self._sync()
        # commit point: snapshot the post-quantum state to the host, THEN
        # apply any planned poison — a later guard rejection rolls back to
        # here and replays the remaining rounds bit-identically. A dirty
        # snapshot (corruption that predates the copy — e.g. a poisoned
        # tree that ran another quantum before the guard could see it) must
        # NOT overwrite the last good commit point: rolling back into the
        # corruption would retry forever.
        if self._snapshots:
            with self._device_wait("snapshot", rid=t.req.rid):
                snap = resilience.snapshot_search(
                    st.tree, st.metrics, st.round_idx, st.playouts,
                    len(t.req.out))
            if resilience.snapshot_is_clean(snap):
                st.snap = snap
        if self.injector is not None and slot_key is not None:
            ev = self.injector.poison(self._flat_slot(slot_key))
            if ev is not None:
                self._record_injected(ev)
                st.tree = resilience.poison_root_stats(st.tree)

    # -- slot lifecycle ---------------------------------------------------
    def _retire(self, ck: GSCPMConfig, s: int, t: Ticket) -> None:
        """Dispatch the retirement summary on device; pull it NOW (blocking
        mode) or a tick later (``self.pipeline``), freeing the slot
        immediately so admission refills it while the readback is still in
        flight (DESIGN.md §18). Pipelined, the summary's device-to-host
        copy is queued behind it now (``_stage_summary``) and only that
        copy's event is waited on later."""
        st = self._states[t.req.rid]
        n_moves = st.cfg.game_obj.n_actions
        if self.tracer:
            # tracer implies pipelining is off: block here so the trace
            # attributes the retirement device sync honestly (§15)
            with self.tracer.span("device_sync", {"rid": t.req.rid}):
                with self._device_wait("device_sync", rid=t.req.rid):
                    self._sync()
        if st.n_trees > 1:
            forest = st.tree
            if st.n_padded > st.n_trees:
                # sharding pads never ran a playout; slice them off so the
                # merge, vote, and node count see only real members
                forest = Tree(*(x[:st.n_trees] for x in forest))
            dev = forest_retire_summary(forest, n_moves)
        else:
            dev = root_summary_device(st.tree, n_moves)
        if self.pipeline:
            self._states.pop(t.req.rid)
            self.pools[ck][s] = None
            self._pending_retire.append((ck, s, t, st,
                                         *self._stage_summary(dev)))
            return
        with self._device_wait("retire_summary", rid=t.req.rid):
            self._materialize_retirement(ck, s, t, st, dev)

    def _materialize_retirement(self, ck: GSCPMConfig, s: int, t: Ticket,
                                st: _SearchState, dev: dict) -> None:
        """Pull a dispatched retirement summary to the host, run the result
        guard, and finalize the request. In blocking mode the search is
        still registered and the slot still held; in pipelined mode both
        were released at detection, so failure takes the deferred path."""
        deferred = t.req.rid not in self._states
        warm = st.session is not None or st.reused_nodes \
            or st.reused_visits > 0
        if st.n_trees > 1:
            res = materialize_forest_summary(dev, st.n_trees)
        else:
            res = materialize_root_summary(
                dev, reused_visits=int(st.reused_visits) if warm else None)
        if self.guard:
            # host-side result guard (DESIGN.md §17): a corrupted answer
            # never ships — it becomes a retry from the last committed
            # snapshot, and the slot takes a quarantine strike
            bad = resilience.validate_result(
                res, None if warm else st.playouts)
            if bad:
                if self.tracer:
                    self.tracer.instant("guard_reject", {
                        "rid": t.req.rid, "game": st.cfg.game, "slot": s,
                        "violations": "; ".join(bad)})
                if self.registry:
                    self.registry.counter(
                        "serve_guard_failures_total",
                        "retired answers rejected by the result "
                        "guard").inc()
                err = ResultGuardError("; ".join(bad))
                if deferred:
                    self._fail_deferred(ck, s, t, err)
                else:
                    self._fail_slot(ck, s, t, err)
                return
        if not deferred:
            self._states.pop(t.req.rid)
        t.t_done = self._now()
        res.update(
            game=st.cfg.game, board_size=st.cfg.board_size,
            playouts=st.playouts, rounds=st.round_idx,
            rounds_total=len(st.schedule), deadline_expired=st.expired,
            status="deadline_expired" if st.expired else "answered",
            retries=t.retries, preemptions=t.preemptions,
            queue_wait_s=t.t_admit - t.t_submit,
            latency_s=t.t_done - t.t_submit)
        if st.session is not None or st.reused_nodes:
            res["reused_nodes"] = st.reused_nodes
        if st.cfg.metrics:
            mm = st.metrics
            if st.n_padded > st.n_trees:
                mm = type(mm)(*(x[:st.n_trees] for x in mm))
            res["metrics"] = summarize_metrics(mm)
        if self.pools[ck][s] is t:
            # blocking mode still holds the slot; a deferred retirement
            # freed it at detection and it may already host a new search
            self.pools[ck][s] = None
        t.req.result = res
        t.req.done = True
        if st.session is not None:
            # hand the finished tree back to its tenant: the session's
            # next ``play(move)`` re-roots it and the move after searches
            # warm — this is the whole cross-move reuse loop
            st.session._deliver(st.tree, res)
        self.finished.append(t.req)
        self.finished_tickets.append(t)
        if self.tracer:
            self.tracer.instant("retire", {
                "rid": t.req.rid, "game": st.cfg.game, "slot": s,
                "quanta": t.quanta, "preemptions": t.preemptions,
                "rounds": st.round_idx, "playouts": st.playouts,
                "deadline_expired": st.expired,
                "latency_s": round(t.t_done - t.t_submit, 6)})
        if self.registry:
            self.registry.counter("serve_requests_finished_total",
                                  "requests retired complete").inc()
            self.registry.counter("serve_playouts_total",
                                  "playouts committed across all "
                                  "retired searches").inc(st.playouts)

    def _preempt(self, ck: GSCPMConfig, s: int, t: Ticket) -> None:
        """Tail-requeue (round-robin sharing within the class). The tree
        stays in ``self._states`` — nothing to replay on re-admission."""
        self.pools[ck][s] = None
        t.preemptions += 1
        self.queue.append(t)
        if self.tracer:
            st = self._states[t.req.rid]
            self.tracer.instant("preempt", {
                "rid": t.req.rid, "game": ck.game, "slot": s,
                "quanta_run": t.quanta - t.quanta_at_admit,
                "rounds_done": st.round_idx,
                "progress": len(t.req.out) - t.seg_base})
        if self.registry:
            self.registry.counter("serve_preemptions_total",
                                  "over-budget requests requeued").inc()

    def _fail_slot(self, ck: GSCPMConfig, s: int, t: Ticket,
                   err: Exception) -> None:
        """Contain a slot failure: free the slot, roll the search back to
        its last committed snapshot (or rebuild it from round 0), requeue
        the ticket with exponential backoff, and count a quarantine strike
        against the slot. The ``TPFIFODriver`` run loop never sees the
        exception.

        Rollback restores the EXACT device state of the commit point —
        tree, metrics accumulator, round index, committed-playouts count,
        and the ``out`` progress log — so the replayed rounds reproduce
        the uninterrupted search bit for bit (RNG streams depend only on
        ``(key, round.task_ids)``, never on wall-clock or retry count).
        """
        self.pools[ck][s] = None
        st = self._states[t.req.rid]
        if st.snap is not None:
            tree, metrics = resilience.restore_search(st.snap)
            st.tree = tree
            st.metrics = metrics
            st.round_idx = st.snap.round_idx
            st.playouts = st.snap.playouts
            st.expired = False
            del t.req.out[st.snap.out_len:]
        else:
            # no snapshot discipline (no injector attached and snapshots
            # not forced): the device state is suspect, so rebuild the
            # search from scratch — still a correct answer, just a cold
            # restart (a lost warm-session tree falls back to full budget)
            self._states.pop(t.req.rid)
            del t.req.out[:]
            self._states[t.req.rid] = self._make_state(
                self.request_cfg(t.req), t)
        self._requeue_for_retry(t, err)
        self._note_slot_failure((ck, s))
        self._sync_active()

    def _fail_deferred(self, ck: GSCPMConfig, s: int, t: Ticket,
                       err: Exception) -> None:
        """Guard rejection surfacing a tick AFTER the slot was freed: the
        search state was popped at detection and the slot may already host
        a new search, so only the ticket rolls back — a cold rebuild from
        round 0 (pipelining and snapshot discipline are mutually exclusive,
        so there is never a commit point to restore) plus a quarantine
        strike against the slot that produced the bad answer."""
        del t.req.out[:]
        self._states[t.req.rid] = self._make_state(
            self.request_cfg(t.req), t)
        self._requeue_for_retry(t, err)
        self._note_slot_failure((ck, s))
        self._sync_active()


# ---------------------------------------------------------------- session ----
class GameSession:
    """A stateful tenant: one game played move by move through the engine
    (DESIGN.md §16).

    The session owns the game's host-side position (board, side to move,
    move list) and — between searches — the device-resident search tree.
    Lifecycle per move:

    1. ``make_request(...)`` builds a ``GameRequest`` bound to this session
       (current position, current side, per-move seed); submit it to the
       engine and drive ``step()``/``run()`` as usual.
    2. At admission the engine checks the session's tree out
       (``_checkout``) and warm-starts the search from it; the budget
       shrinks by the retained root evidence (``warm_budget``), so
       ``n_playouts`` always means total evidence at the root.
    3. At retirement the searched tree is handed back (``_deliver``).
    4. ``play(move)`` applies the move to the board and re-roots the tree
       onto the played child (``core.tree.reroot_tree``) — the retained
       subtree seeds the NEXT search warm.

    One request may be in flight per session (the tree has one owner, and
    the warm search writes into it in place); ``make_request`` enforces it.
    ``reuse_tree=False`` keeps the full session bookkeeping but drops the
    tree at every ``play`` — the cold ablation arm of the self-play
    benchmark. A session request is an ordinary request of its game class,
    sharing the class's slot pool. The session's board lives on its
    engine's device.
    """

    def __init__(self, engine: TPFIFOGameEngine, game: str, board_size: int,
                 *, reuse_tree: bool = True, base_seed: int = 0,
                 name: str | None = None):
        self.engine = engine
        self.device = engine.device
        self.game = game
        self.board_size = board_size
        self.reuse = reuse_tree
        self.base_seed = base_seed
        self.name = name or f"{game}{board_size}-{base_seed}"
        self.game_obj = game_mod.make_game(game, board_size)
        self.board = self.game_obj.init_board(self.device)
        self.to_move = 1
        self.moves: list[int] = []
        self.tree: Tree | None = None       # warm tree for the NEXT search
        self.last_result: dict | None = None
        # per-move retention telemetry (what examples/benchmarks print)
        self.retained_visits = 0.0
        self.retained_fraction = 0.0
        self._pending = False

    # -- engine-facing tree custody ---------------------------------------
    def _checkout(self) -> Tree | None:
        """Engine takes the tree at admission (single-owner discipline: the
        search updates the tree in place, so the session must not hold a
        reference while the search runs)."""
        tree, self.tree = self.tree, None
        return tree

    def _deliver(self, tree: Tree, result: dict) -> None:
        """Engine hands the searched tree back at retirement."""
        self.tree = tree if self.reuse else None
        self.last_result = result
        self._pending = False

    # -- client API -------------------------------------------------------
    def make_request(self, rid: Any = None, *, n_playouts: int = 512,
                     n_tasks: int = 16, cp: float = 1.0,
                     seed: int | None = None,
                     deadline_s: float | None = None) -> GameRequest:
        """A ``GameRequest`` for the session's current position.

        ``seed`` defaults to ``base_seed + move number`` — deterministic
        per-move streams, so whole games replay bit-identically.
        """
        if self._pending:
            raise RuntimeError(
                f"session {self.name}: a request is already in flight — "
                "the device tree has one owner; await its result and "
                "play() before searching again")
        self._pending = True
        return GameRequest(
            rid=(rid if rid is not None
                 else f"{self.name}#mv{len(self.moves)}"),
            game=self.game, board_size=self.board_size,
            to_move=self.to_move, n_playouts=n_playouts, n_tasks=n_tasks,
            cp=cp, seed=(self.base_seed + len(self.moves)
                         if seed is None else seed),
            deadline_s=deadline_s, board=self.board.cpu().numpy().copy(),
            session=self)

    def play(self, move: int) -> None:
        """Commit a move: update the position and re-root the tree onto the
        played child so the next search starts warm.

        Any legal move works — the opponent's reply included, whether or
        not this session's searches ever expanded it (an unseen move just
        yields a 1-node tree, a cold start in warm clothing).
        """
        if self._pending:
            raise RuntimeError(
                f"session {self.name}: cannot play() while a request is in "
                "flight — the engine owns the tree")
        move = int(move)
        legal = self.game_obj.legal_mask(self.board).cpu().numpy()
        if not legal[move]:
            raise ValueError(
                f"session {self.name}: illegal move {move} for "
                f"{self.game} at move {len(self.moves)}")
        if self.reuse and self.tree is not None:
            before = float(self.tree.visits[0])
            self.tree = reroot_tree(self.tree, move)
            self.retained_visits = float(self.tree.visits[0])
            self.retained_fraction = (self.retained_visits / before
                                      if before > 0 else 0.0)
        else:
            self.tree = None
            self.retained_visits = 0.0
            self.retained_fraction = 0.0
        self.board = self.game_obj.place(self.board, move, self.to_move)
        self.to_move = 3 - self.to_move
        self.moves.append(move)

    def winner(self) -> int:
        """Game status at the current position via ``Game.winner_probe``:
        -1 ongoing, 0 draw, 1/2 the winning player."""
        return int(self.game_obj.winner_probe(self.board))

    def over(self) -> bool:
        return self.winner() >= 0


# the protocol-level name; TPFIFO is the (only) scheduling flavor today
GameSearchEngine = TPFIFOGameEngine
