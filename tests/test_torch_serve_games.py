"""The port's game-serving engine against the JAX package's (DESIGN.md §14).

The same traffic goes through ``repro.serve.games.TPFIFOGameEngine`` and
``repro_torch.serve.games.TPFIFOGameEngine(device="cpu")`` at 5x5 with 4
workers and ``tree_cap=512``; every answer is compared field by field and
exactly (root visits and wins, best move, value, tree nodes, playouts,
rounds, status), and so are the admission order, each ticket's
preemptions, quanta and retries, and ``QueueStats``' counts. Times are
never compared. Each JAX scenario runs once, in a module-scoped fixture.

The scenarios are those of ``tests/test_serve_games.py`` and the serving
half of ``tests/test_obsv.py``: preempted quanta equal to uninterrupted
(Hex and Gomoku), mixed classes, a saturated class, FIFO admission,
``deadline_s=0``, budget conservation, ``submit``'s typed errors, no
kernel build after the first request, the scheduling property on a
stubbed dispatch, and the served trace's vocabulary.
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
from hypcompat import given, settings, st
from torch_parity_util import (RESULT_FIELDS, STATS_COUNTS,
                               assert_same_serving, make_engine,
                               port_reference, result_differences,
                               serving_packages, ticket_log)

from repro.serve import tpfifo as jtpfifo
from repro_torch.core import scheduler as tsched
from repro_torch.obsv import MetricsRegistry, TraceRecorder, validate_trace
from repro_torch.obsv.trace import kernel_builds
from repro_torch.serve import games as tgames
from repro_torch.serve import tpfifo as ttpfifo

torch.set_num_threads(1)

SIZE = 5
CAP = 512
PKGS = ("jax", "torch")


def engine(pkg, **kw):
    kw.setdefault("n_slots", 1)
    kw.setdefault("grain", 1)
    kw.setdefault("n_workers", 4)
    kw.setdefault("tree_cap", CAP)
    return make_engine(pkg, **kw)


def req(pkg, rid, game="hex", **kw):
    games, _ = serving_packages()[pkg]
    kw.setdefault("board_size", SIZE)
    kw.setdefault("n_playouts", 64)
    kw.setdefault("n_tasks", 8)
    kw.setdefault("seed", rid)
    return games.GameRequest(rid=rid, game=game, **kw)


def midgame_board(k=4, seed=0):
    rng = np.random.default_rng(seed)
    b = np.zeros(SIZE * SIZE, dtype=np.int8)
    for t, i in enumerate(rng.permutation(SIZE * SIZE)[:k]):
        b[i] = 1 if t % 2 == 0 else 2
    return b


def serve(engine_kw: dict, traffic: list[tuple]):
    """Run ``traffic`` ((rid, game, request kwargs) triples) through both
    engines; {pkg: (engine, requests)}."""
    out = {}
    for pkg in PKGS:
        eng = engine(pkg, **engine_kw)
        reqs = [req(pkg, rid, game, **kw) for rid, game, kw in traffic]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[pkg] = (eng, reqs)
    return out


def assert_both_equal(runs):
    (je, jr), (te, tr) = runs["jax"], runs["torch"]
    assert_same_serving(je, te, jr, tr)


def assert_equals_uninterrupted(eng, r):
    ref = port_reference(eng, r)
    assert result_differences(r.result, ref, ("root_visits", "root_wins",
                                              "best_move", "root_value",
                                              "tree_nodes")) == []


# ------------------------------------------------------------ bit-identity ----
@pytest.fixture(scope="module", params=["hex", "gomoku"])
def preempted(request):
    """Two same-class requests on ONE slot with preempt_quanta=1: tail
    requeue every quantum; the second starts midgame with to_move=2."""
    g = request.param
    return g, serve(dict(preempt_quanta=1), [
        (0, g, {}),
        (1, g, dict(n_playouts=32, n_tasks=4, board=midgame_board(),
                    to_move=2))])


def test_preempted_quanta_equal_jax_engine(preempted):
    _, runs = preempted
    assert_both_equal(runs)
    assert runs["torch"][0].stats().n_preemptions > 0


def test_preempted_quanta_equal_uninterrupted(preempted):
    _, runs = preempted
    eng, reqs = runs["torch"]
    for r in reqs:
        assert not r.result["deadline_expired"]
        assert r.result["rounds"] == r.result["rounds_total"]
        assert_equals_uninterrupted(eng, r)


MIXED = [(0, "hex", {}), (1, "gomoku", dict(n_playouts=48, n_tasks=12)),
         (2, "hex", dict(n_playouts=32, n_tasks=4, cp=1.7)),
         (3, "gomoku", dict(n_playouts=64, n_tasks=16, cp=0.4))]


@pytest.fixture(scope="module")
def mixed():
    return serve(dict(n_slots=1, grain=2, preempt_quanta=1), MIXED)


def test_mixed_class_traffic_equal_jax_engine(mixed):
    assert_both_equal(mixed)


@pytest.mark.parametrize("rid", range(len(MIXED)))
def test_mixed_class_traffic_equal_uninterrupted(mixed, rid):
    eng, reqs = mixed["torch"]
    assert_equals_uninterrupted(eng, reqs[rid])


# ------------------------------------------------------------- admission ----
def test_fifo_admission_order_mixed_classes_and_budgets():
    mix = [("hex", 32), ("gomoku", 64), ("hex", 16), ("gomoku", 32),
           ("hex", 48)]
    runs = serve(dict(n_slots=3, grain=2),
                 [(i, g, dict(n_playouts=n, n_tasks=4))
                  for i, (g, n) in enumerate(mix)])
    assert_both_equal(runs)
    assert runs["torch"][0].admission_order == [0, 1, 2, 3, 4]


def test_saturated_class_never_blocks_other_class():
    runs = serve(dict(n_slots=1, grain=2), [
        (0, "hex", {}), (1, "hex", dict(n_playouts=32, n_tasks=4)),
        (2, "gomoku", dict(n_playouts=32, n_tasks=4))])
    assert_both_equal(runs)
    assert runs["torch"][0].admission_order == [0, 2, 1]


# ------------------------------------------------------- pools and builds ----
def test_one_pool_per_class_and_no_kernel_build_after_first_request():
    """The port has no jit cache: "zero recompiles" is one slot pool per
    game class whatever the per-request budget/Cp/grain/deadline, and no
    build of the kernel library once the first request has been served."""
    sweeps = [("hex", 16, 2, 0.4, None), ("gomoku", 48, 6, 1.7, 30.0),
              ("hex", 96, 12, 2.5, 30.0), ("gomoku", 24, 24, 0.9, None),
              ("hex", 40, 5, 1.0, 30.0)]
    out = {}
    for pkg in PKGS:
        eng = engine(pkg, n_slots=2, grain=3, policy="rebalance",
                     preempt_quanta=2)
        reqs = [req(pkg, i, g, n_playouts=n, n_tasks=t, cp=cp, deadline_s=dl)
                for i, (g, n, t, cp, dl) in enumerate(sweeps)]
        eng.submit(reqs[0])
        eng.run()
        builds = kernel_builds()
        for r in reqs[1:]:
            eng.submit(r)
        eng.run()
        assert kernel_builds() == builds
        out[pkg] = (eng, reqs)
    je, te = out["jax"][0], out["torch"][0]
    key = lambda ck: (ck.game, ck.board_size, ck.n_workers, ck.tree_cap)
    assert [key(k) for k in te.pools] == [key(k) for k in je.pools] == [
        ("hex", SIZE, 4, CAP), ("gomoku", SIZE, 4, CAP)]
    assert_both_equal(out)


def test_class_key_ignores_budget_knobs():
    eng = engine("torch")
    a = eng.request_cfg(req("torch", 0, n_playouts=16, n_tasks=2, cp=0.3))
    b = eng.request_cfg(req("torch", 1, n_playouts=999, n_tasks=7, cp=2.0))
    c = eng.request_cfg(req("torch", 2, game="gomoku"))
    assert a == b and hash(a) == hash(b) and a != c
    assert (b.n_playouts, b.n_tasks, b.cp) == (999, 7, 2.0)


# -------------------------------------------------------------- deadlines ----
@pytest.fixture(scope="module")
def expired():
    return serve({}, [(0, "hex", dict(deadline_s=0.0)),
                      (1, "hex", dict(n_playouts=32, n_tasks=4))])


def test_deadline_zero_equal_jax_engine(expired):
    assert_both_equal(expired)


def test_deadline_zero_retires_without_poisoning_slot(expired):
    eng, (dead, follow) = expired["torch"]
    assert dead.done and dead.result["deadline_expired"]
    assert dead.result["status"] == "deadline_expired"
    assert dead.result["rounds"] == 0 and dead.result["playouts"] == 0
    assert dead.result["best_move"] == -1
    assert (dead.result["root_visits"] == 0).all()
    assert not follow.result["deadline_expired"]
    assert follow.result["playouts"] == 32
    assert_equals_uninterrupted(eng, follow)
    assert eng.stats().n_finished == 2


def test_mid_search_deadline_ships_partial_stats():
    """A wall-clock deadline mid-search retires the request with a
    consistent partial summary (port only: the instant is wall-clock)."""
    eng = engine("torch")
    r = req("torch", 0, n_playouts=8192, n_tasks=2048, deadline_s=0.2)
    eng.submit(r)
    eng.run()
    assert r.done and r.result["deadline_expired"]
    assert 0 < r.result["rounds"] < r.result["rounds_total"] == 512
    assert r.result["root_visits"].sum() == r.result["playouts"] > 0
    assert r.result["best_move"] >= 0


# ------------------------------------------------- budgets and telemetry ----
@pytest.fixture(scope="module")
def budgets():
    mix = [("hex", 64, 8), ("gomoku", 32, 8), ("hex", 32, 4),
           ("gomoku", 64, 16)]
    return serve(dict(n_slots=2, grain=2, preempt_quanta=1),
                 [(i, g, dict(n_playouts=n, n_tasks=t))
                  for i, (g, n, t) in enumerate(mix)])


def test_budget_conservation_equal_jax_engine(budgets):
    assert_both_equal(budgets)


def test_playout_budget_conserved_and_queue_stats(budgets):
    eng, reqs = budgets["torch"]
    rounds_total = 0
    for r in reqs:
        cfg = eng.request_cfg(r)
        sch = tsched.make_schedule(cfg.n_playouts, cfg.n_tasks,
                                   cfg.n_workers, cfg.scheduler)
        assert r.result["playouts"] == \
            tsched.schedule_stats(sch)["lane_iterations"]
        assert r.result["root_visits"].sum() == r.result["playouts"]
        assert 0 <= r.result["queue_wait_s"] <= r.result["latency_s"]
        rounds_total += r.result["rounds"]
    stats = eng.stats()
    assert isinstance(stats, ttpfifo.QueueStats)
    assert stats.n_finished == 4 and stats.tokens == rounds_total
    assert stats.quanta >= 4
    assert 0 <= stats.latency_p50 <= stats.latency_p95


# ------------------------------------------------------- submit validation ----
BAD_REQUESTS = [
    (dict(game="chess"), None),
    (dict(board=np.zeros(7, np.int8)), "board shape"),
    (dict(n_playouts=0), "n_playouts"),
    (dict(n_playouts=2.5), "n_playouts"),
    (dict(n_playouts=True), "n_playouts"),
    (dict(n_tasks=-1), "n_tasks"),
    (dict(to_move=3), "to_move"),
    (dict(cp=float("nan")), "cp"),
    (dict(cp=-0.5), "cp"),
    (dict(cp="high"), "cp"),
    (dict(deadline_s=-1.0), "deadline_s"),
    (dict(deadline_s=float("inf")), "deadline_s"),
    (dict(deadline_s="soon"), "deadline_s"),
    (dict(board=np.zeros(SIZE * SIZE, np.float32)), "board dtype"),
    (dict(board=np.full(SIZE * SIZE, 7, np.int8)), "board cells"),
    (dict(n_trees=0), "n_trees"),
    (dict(n_trees=2, session=object()), "stateless"),
]


@pytest.mark.parametrize("bad,match", BAD_REQUESTS,
                         ids=[f"{next(iter(b))}-{i}"
                              for i, (b, _) in enumerate(BAD_REQUESTS)])
def test_submit_typed_errors_equal_jax_engine(bad, match):
    """Each malformed request fails at ``submit`` with the JAX engine's
    exception type and message, and nothing leaks into the queue."""
    errs = {}
    for pkg in PKGS:
        eng = engine(pkg)
        with pytest.raises((ValueError, TypeError)) as info:
            eng.submit(req(pkg, "bad", **bad))
        errs[pkg] = (type(info.value), str(info.value))
        assert not eng.has_work()
    assert errs["jax"] == errs["torch"]
    if match:
        assert match in errs["torch"][1]


# ----------------------------------------------------- scheduling property ----
def _stub_round(tree, board, cfg, key, rnd, cp):
    return tree


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), slots=st.sampled_from([1, 2]),
       grain=st.sampled_from([1, 2, 4]), preempt=st.sampled_from([1, 2]))
def test_property_mixed_traffic_never_starves(seed, slots, grain, preempt):
    """Search dispatch stubbed out in both engines: any mix of classes,
    budgets and grains drains completely, with the same admission order
    and the same per-ticket preemptions and quanta; every request runs its
    exact round budget, each segment commits >= 1 round, and per-class
    admission follows submission."""
    rng = np.random.default_rng(seed)
    games = ("hex", "gomoku")
    traffic = [(i, games[int(rng.integers(2))],
                dict(n_playouts=int(rng.integers(8, 129)),
                     n_tasks=int(2 ** rng.integers(0, 5))))
               for i in range(int(rng.integers(3, 8)))]
    with mock.patch("repro.serve.games.run_schedule_round", _stub_round), \
            mock.patch("repro_torch.serve.games.run_schedule_round",
                       _stub_round):
        runs = serve(dict(n_slots=slots, grain=grain, preempt_quanta=preempt,
                          tree_cap=64, guard=False), traffic)
    (je, jr), (te, tr) = runs["jax"], runs["torch"]
    assert te.admission_order == je.admission_order
    assert ticket_log(te) == ticket_log(je)
    assert len(te.finished) == len(tr)
    for r in tr:
        cfg = te.request_cfg(r)
        sch = tsched.make_schedule(cfg.n_playouts, cfg.n_tasks,
                                   cfg.n_workers, cfg.scheduler)
        assert r.result["rounds"] == len(sch)
        assert r.result["playouts"] == \
            tsched.schedule_stats(sch)["lane_iterations"]
    for t in te.finished_tickets:
        assert t.preemptions + 1 <= len(t.req.out)
    first = list(dict.fromkeys(te.admission_order))
    for g in games:
        assert [rid for rid in first if tr[rid].game == g] == [
            r.rid for r in tr if r.game == g]


# ------------------------------------------------------------ serving trace ----
TRACED = [(0, "hex", dict(n_playouts=64)), (1, "gomoku", dict(n_playouts=32)),
          (2, "hex", dict(n_playouts=32)),
          (99, "hex", dict(n_playouts=64, seed=9, deadline_s=0.0))]


@pytest.fixture(scope="module")
def traced():
    """A preempting, deadline-bearing run with a tracer, a registry and
    the device counters on, in both packages; and the port's run with no
    observer."""
    from repro.obsv import MetricsRegistry as JRegistry
    from repro.obsv import TraceRecorder as JRecorder
    observers = {"jax": (JRecorder(), JRegistry()),
                 "torch": (TraceRecorder(), MetricsRegistry())}
    out = {}
    for pkg in PKGS:
        tr, reg = observers[pkg]
        eng = engine(pkg, preempt_quanta=1, metrics=True, tracer=tr,
                     registry=reg)
        reqs = [req(pkg, rid, g, n_tasks=8, **kw) for rid, g, kw in TRACED]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[pkg] = (eng, reqs, tr, reg)
    plain = engine("torch", preempt_quanta=1)
    preqs = [req("torch", rid, g, n_tasks=8, **kw) for rid, g, kw in TRACED]
    for r in preqs:
        plain.submit(r)
    plain.run()
    out["plain"] = (plain, preqs)
    return out


def test_traced_run_equal_jax_engine_counters_included(traced):
    je, jr, _, _ = traced["jax"]
    te, tr, _, _ = traced["torch"]
    assert_same_serving(je, te, jr, tr)
    assert all("metrics" in r.result for r in tr
               if not r.result["deadline_expired"])


def test_served_trace_carries_scheduling_vocabulary(traced, tmp_path):
    eng, reqs, tr, reg = traced["torch"]
    names = {e["name"] for e in tr.events}
    assert {"admission", "quantum", "preempt", "retire", "deadline_expiry",
            "device_sync", "tick", "queue"} <= names
    assert validate_trace(tr.to_dict()) == len(tr.events)
    assert validate_trace(tr.save(str(tmp_path / "serve.json"))) > 0
    m = reg.snapshot()["metrics"]
    assert m["serve_requests_finished_total"]["value"] == 4
    assert m["serve_preemptions_total"]["value"] == eng.stats().n_preemptions
    assert m["serve_deadline_expiries_total"]["value"] >= 1
    quanta = [e for e in tr.events if e["name"] == "quantum"]
    assert quanta and all(e["ph"] == "X" and "dur" in e
                          and "rounds" in e["args"]
                          and "iterations" in e["args"] for e in quanta)
    assert sum(e["args"]["rounds"] for e in quanta) == eng.stats().tokens


INSTANTS = ("admission", "preempt", "retire", "deadline_expiry")


def _instant_log(tr) -> list:
    keep = ("rid", "game", "slot", "resumed", "quanta", "preemptions",
            "rounds", "playouts", "rounds_done", "rounds_total",
            "quanta_run", "progress", "deadline_expired")
    return [(e["name"], {k: e["args"][k] for k in keep if k in e["args"]})
            for e in tr.events if e["name"] in INSTANTS]


def test_served_trace_instants_equal_jax_engine(traced):
    """The admission, preempt, retire and deadline-expiry instants come in
    the JAX engine's order with its arguments (times aside)."""
    _, _, jtr, _ = traced["jax"]
    _, _, ttr, _ = traced["torch"]
    assert _instant_log(ttr) == _instant_log(jtr)
    assert {n for n, _ in _instant_log(ttr)} == set(INSTANTS)


def test_registry_counts_equal_jax_engine(traced):
    _, _, _, jreg = traced["jax"]
    _, _, _, treg = traced["torch"]
    jm, tm = jreg.snapshot()["metrics"], treg.snapshot()["metrics"]
    counters = sorted(k for k, v in jm.items() if v.get("type") == "counter")
    assert counters and counters == sorted(
        k for k, v in tm.items() if v.get("type") == "counter")
    assert {k: jm[k]["value"] for k in counters} == {
        k: tm[k]["value"] for k in counters}


def test_observers_do_not_perturb_answers(traced):
    _, reqs, _, _ = traced["torch"]
    _, plain = traced["plain"]
    for r_obs, r_plain in zip(reqs, plain):
        assert r_obs.rid == r_plain.rid
        assert result_differences(r_obs.result, r_plain.result,
                                  RESULT_FIELDS) == []


# -------------------------------------------------------- QueueStats fixes ----
def _ticket(mod, out_len=0, preemptions=0, quanta=0, done_at=None):
    @dataclasses.dataclass
    class R:
        rid: int = 0
        out: list = dataclasses.field(default_factory=list)
        done: bool = False

    t = mod.Ticket(req=R(out=list(range(out_len))), t_submit=0.0)
    t.preemptions, t.quanta = preemptions, quanta
    if done_at is not None:
        t.t_admit, t.t_done = 0.1, done_at
    return t


@pytest.mark.parametrize("tickets", [
    [(3, 2, 5, None), (1, 1, 2, None)],
    [(4, 1, 3, 1.0), (2, 2, 2, None)],
    [(4, 0, 3, 1.0), (2, 1, 2, 0.5), (1, 0, 1, 2.0)]],
    ids=["none-finished", "mixed", "all-finished"])
def test_queue_stats_equal_jax_package(tickets):
    """``QueueStats.from_tickets`` gives the JAX package's every field on
    the same tickets, finished or not."""
    a = jtpfifo.QueueStats.from_tickets([_ticket(jtpfifo, *t)
                                         for t in tickets])
    b = ttpfifo.QueueStats.from_tickets([_ticket(ttpfifo, *t)
                                         for t in tickets])
    assert a.as_dict() == b.as_dict()
    assert list(b.as_dict()) == [f.name for f in
                                 dataclasses.fields(ttpfifo.QueueStats)]


def test_engine_stats_cover_active_and_queued_tickets():
    with mock.patch("repro_torch.serve.games.run_schedule_round",
                    _stub_round):
        eng = engine("torch", preempt_quanta=1, tree_cap=64)
        for i in range(3):
            eng.submit(req("torch", i, n_playouts=512, n_tasks=64))
        eng.run(max_ticks=3, on_exhaust="ignore")
    stats = eng.stats()
    assert stats.n_finished == 0 and stats.n_unfinished == 3
    assert stats.quanta > 0 and stats.tokens > 0 and stats.n_preemptions > 0
    assert set(STATS_COUNTS) <= set(stats.as_dict())


# ------------------------------------------------------------- entry points ----
def test_engine_runs_on_the_gpu_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    eng = tgames.TPFIFOGameEngine(n_workers=4, tree_cap=64)
    assert eng.device == torch.device("cuda")
    assert eng.submit(tgames.GameRequest(rid=0, board_size=SIZE,
                                         n_playouts=8, n_tasks=2))
    with pytest.raises((AssertionError, RuntimeError)):
        eng.run()
