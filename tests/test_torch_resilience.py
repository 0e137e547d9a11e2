"""The port's chaos layer against the JAX package's (DESIGN.md §17).

``repro_torch.serve.resilience`` and the port's engine under faults: the
same ``FaultPlan`` (which must equal the JAX package's at the same seed)
drives both engines over the same traffic at 5x5, 4 workers and
``tree_cap=512``, and every answer, admission, per-ticket retry count and
``QueueStats`` count must be equal, and equal to the fault-free run. The
scenarios are those of ``tests/test_resilience.py``: dispatch, poison and
mixed chaos, quarantine (and never of the last healthy slot), shedding,
duplicates, clock stalls, the result guard, snapshots, and the exhausted
tick budget. The flatten helpers the snapshots use
(``repro_torch.checkpoint.store``) give the JAX package's paths.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch
from hypcompat import given, settings, st
from torch_parity_util import (assert_same_serving, make_engine,
                               port_reference, result_differences,
                               serving_packages)

from repro.checkpoint import store as jstore
from repro.core import tree as jtree
from repro.obsv import search_metrics as jmetrics
from repro.serve import resilience as jres
from repro_torch.checkpoint import store as tstore
from repro_torch.core import tree as ttree
from repro_torch.obsv import search_metrics as tmetrics
from repro_torch.obsv.trace import kernel_builds
from repro_torch.serve import resilience as tres

torch.set_num_threads(1)

SIZE = 5
CAP = 512
PKGS = ("jax", "torch")
SUMMARY = ("root_visits", "root_wins", "best_move", "root_value",
           "tree_nodes")


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
    kw.setdefault("n_tasks", 16)     # 4 schedule rounds at W=4
    kw.setdefault("seed", rid if isinstance(rid, int) else 0)
    return games.GameRequest(rid=rid, game=game, **kw)


def events(pkg, evs):
    """A FaultPlan of ``(tick, slot, kind[, stall_s])`` in ``pkg``."""
    _, res = serving_packages()[pkg]
    return res.FaultPlan(events=tuple(res.FaultEvent(*e) for e in evs))


def chaos(engine_kw, traffic, plan=None, max_ticks=5000):
    """``traffic`` through both engines, each with its own package's
    injector on ``plan(pkg)`` (None: fault-free); {pkg: (eng, reqs, inj)}."""
    out = {}
    for pkg in PKGS:
        _, res = serving_packages()[pkg]
        inj = None if plan is None else res.FaultInjector(plan(pkg))
        eng = engine(pkg, injector=inj, **engine_kw)
        reqs = [req(pkg, rid, g, **kw) for rid, g, kw in traffic]
        for r in reqs:
            eng.submit(r)
        eng.run(max_ticks=max_ticks)
        out[pkg] = (eng, reqs, inj)
    return out


def assert_chaos_equal(runs):
    (je, jr, ji), (te, tr, ti) = runs["jax"], runs["torch"]
    assert_same_serving(je, te, jr, tr)
    if ji is not None:
        assert ji.summary() == ti.summary()


def assert_fault_free(eng, reqs):
    """Every answered request equals the port's uninterrupted search."""
    for r in reqs:
        assert r.result["status"] == "answered", r.rid
        ref = port_reference(eng, r)
        assert result_differences(r.result, ref, SUMMARY) == [], r.rid


# -------------------------------------------------------------- fault plan ----
PLANS = [dict(seed=9, n_ticks=50, n_slots=4, rate=0.2),
         dict(seed=10, n_ticks=50, n_slots=4, rate=0.2),
         dict(seed=0, n_ticks=4096, n_slots=4, rate=0.05),
         dict(seed=13, n_ticks=60, n_slots=4, rate=0.3),
         dict(seed=3, n_ticks=40, n_slots=2, rate=0.5,
              kinds=("dispatch_error", "poison_nan"), stall_s=1.5),
         dict(seed=5, n_ticks=20, n_slots=3, rate=1.0, kinds=("clock_stall",),
              stall_s=2.0)]


@pytest.mark.parametrize("kw", PLANS, ids=[f"seed{p['seed']}-r{p['rate']}"
                                           for p in PLANS])
def test_fault_plan_equals_jax_package(kw):
    a = jres.FaultPlan.generate(**kw)
    b = tres.FaultPlan.generate(**kw)
    assert [tuple(vars(e).values()) for e in a.events] == [
        tuple(vars(e).values()) for e in b.events]
    assert (a.seed, a.rate) == (b.seed, b.rate)
    assert all(ev.kind in tres.FAULT_KINDS for ev in b.events)


def test_fault_plan_deterministic_and_seeded():
    a = tres.FaultPlan.generate(seed=9, n_ticks=50, n_slots=4, rate=0.2)
    b = tres.FaultPlan.generate(seed=9, n_ticks=50, n_slots=4, rate=0.2)
    c = tres.FaultPlan.generate(seed=10, n_ticks=50, n_slots=4, rate=0.2)
    assert a.events == b.events != c.events
    assert all(0 <= ev.tick < 50 and 0 <= ev.slot < 4 for ev in a.events)
    assert 10 <= len(a.events) <= 80


@pytest.mark.parametrize("kw", [dict(rate=1.5), dict(rate=-0.1),
                                dict(rate=0.1, kinds=("segfault",))],
                         ids=["rate-high", "rate-negative", "unknown-kind"])
def test_fault_plan_validates_inputs_as_jax_package(kw):
    msgs = []
    for res in (jres, tres):
        with pytest.raises(ValueError) as info:
            res.FaultPlan.generate(seed=0, n_ticks=5, n_slots=1, **kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_injector_arms_per_tick_and_counts_fired():
    plan = events("torch", [(0, 0, "dispatch_error"), (0, 1, "poison_nan"),
                            (1, 0, "clock_stall", 1.0)])
    inj = tres.FaultInjector(plan)
    assert inj.begin_tick(0) == []
    assert inj.dispatch_fault(1) is None
    assert inj.dispatch_fault(0).kind == "dispatch_error"
    assert inj.dispatch_fault(0) is None
    assert inj.poison(1).kind == "poison_nan"
    assert [ev.kind for ev in inj.begin_tick(1)] == ["clock_stall"]
    assert inj.dispatch_fault(0) is None
    inj.record_fired(plan.events[0])
    assert inj.summary() == {"planned": 3, "fired": {"dispatch_error": 1},
                             "fired_total": 1}


# ------------------------------------------------------------ result guard ----
def _good_res(n=4, total=8.0):
    v = np.full(n, total / n)
    return {"root_visits": v, "root_wins": v * 0.5, "best_move": 0,
            "root_value": 0.5, "tree_nodes": n + 1}


def _corrupt(kind):
    r = _good_res()
    if kind == "nan-wins":
        r["root_wins"] = r["root_wins"] + np.nan
    elif kind == "negative-visits":
        r["root_visits"][0] = -1.0
    elif kind == "wins-above-visits":
        r["root_wins"][0] = r["root_visits"][0] + 1
    elif kind == "nan-value":
        r["root_value"] = float("nan")
    elif kind == "best-move-range":
        r["best_move"] = 99
    elif kind == "inf-visits":
        r["root_visits"][1] = np.inf
    return r


@pytest.mark.parametrize("kind,expected", [
    ("clean", 8), ("clean", None), ("clean", 9), ("nan-wins", 8),
    ("negative-visits", 8), ("wins-above-visits", 8), ("nan-value", 8),
    ("best-move-range", 8), ("inf-visits", None)])
def test_validate_result_equals_jax_package(kind, expected):
    got = tres.validate_result(_corrupt(kind), expected)
    assert got == jres.validate_result(_corrupt(kind), expected)
    assert (got == []) == (kind == "clean" and expected != 9)


# ------------------------------------------------------ flatten, snapshots ----
def _structures(pkg):
    if pkg == "jax":
        t = jtree.init_tree(8, 4, 1)
        return [t, jmetrics.init_search_metrics(),
                {"b": [t.visits, t.wins], "a": t, "c": None}]
    t = ttree.init_tree(8, 4, 1, device="cpu")
    return [t, tmetrics.init_search_metrics(device="cpu"),
            {"b": [t.visits, t.wins], "a": t, "c": None}]


@pytest.mark.parametrize("i", range(3), ids=["tree", "metrics", "nested"])
def test_flatten_paths_equal_jax_package(i):
    j = jstore._flatten(_structures("jax")[i])
    t = tstore._flatten(_structures("torch")[i])
    assert list(j) == list(t)
    for k in j:
        np.testing.assert_array_equal(np.asarray(j[k]), t[k].numpy())


def test_unflatten_like_checks_paths_and_shapes():
    t = ttree.init_tree(8, 4, 1, device="cpu")
    flat = {k: v.clone() for k, v in tstore._flatten(t).items()}
    back = tstore._unflatten_like(t, flat)
    assert type(back) is type(t) and back.visits is flat[".visits"]
    with pytest.raises(KeyError, match=".wins"):
        tstore._unflatten_like(t, {k: v for k, v in flat.items()
                                   if k != ".wins"})
    with pytest.raises(ValueError, match="shape"):
        tstore._unflatten_like(t, {**flat, ".visits": torch.zeros(3)})


def test_snapshot_is_a_host_copy_and_restores_fresh_tensors():
    """A snapshot copies (the search writes trees in place, and on the CPU
    ``.numpy()`` would be a view); a restore makes fresh tensors with the
    template's dtype and device; poison is detected."""
    t = ttree.init_tree(64, 8, 1, device="cpu")
    t.visits[0], t.wins[0] = 4.0, 2.0
    m = tmetrics.init_search_metrics(device="cpu")
    snap = tres.snapshot_search(t, m, round_idx=2, playouts=16, out_len=2)
    t.visits[0] = 99.0                       # the search goes on in place
    assert snap.tree_flat[".visits"][0] == 4.0
    assert tres.snapshot_is_clean(snap)
    back, mback = tres.restore_search(snap)
    assert float(back.visits[0]) == 4.0
    for a, b in zip(t, back):
        assert a.dtype == b.dtype and a.device == b.device
        assert a.data_ptr() != b.data_ptr()
    assert [f.dtype for f in mback] == [f.dtype for f in m]
    back.visits[0] = -3.0                    # the restored copy is its own
    assert tres.restore_search(snap)[0].visits[0] == 4.0
    assert tres.poison_root_stats(back) is back
    assert not tres.snapshot_is_clean(
        tres.snapshot_search(back, None, 2, 16, 2))


def test_poison_equals_jax_package():
    jt0 = jtree.init_tree(16, 4, 1)
    tt0 = ttree.init_tree(16, 4, 1, device="cpu")
    j = jres.poison_root_stats(jt0)
    t = tres.poison_root_stats(tt0)
    for f in ("wins", "visits"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy())


# ---------------------------------------------------- recovery bit-identity ----
@pytest.fixture(scope="module")
def dispatch():
    return chaos(dict(retry_backoff=(1, 2)), [("df", "hex", dict(seed=3))],
                 lambda pkg: events(pkg, [(1, 0, "dispatch_error"),
                                          (2, 0, "dispatch_error")]))


def test_dispatch_fault_equal_jax_engine(dispatch):
    assert_chaos_equal(dispatch)


def test_dispatch_fault_retries_equal_fault_free(dispatch):
    eng, (r,), inj = dispatch["torch"]
    assert inj.fired["dispatch_error"] >= 1
    assert r.result["retries"] >= 1 and eng.stats().n_retries >= 1
    assert_fault_free(eng, [r])


@pytest.fixture(scope="module")
def poisoned():
    return chaos({}, [("poison", "hex", dict(seed=7))],
                 lambda pkg: events(pkg, [(2, 0, "poison_nan")]))


def test_poison_equal_jax_engine(poisoned):
    assert_chaos_equal(poisoned)


def test_poison_guard_rejects_and_recovers(poisoned):
    eng, (r,), inj = poisoned["torch"]
    assert inj.fired["poison_nan"] == 1
    assert r.result["retries"] >= 1
    assert np.isfinite(r.result["root_wins"]).all()
    assert_fault_free(eng, [r])


MIXED_TRAFFIC = [(i, ("hex", "gomoku")[i % 2], dict(seed=i))
                 for i in range(6)]


@pytest.fixture(scope="module")
def mixed_chaos():
    return chaos(dict(n_slots=2, grain=2, quarantine_after=3,
                      retry_backoff=(1, 4)), MIXED_TRAFFIC,
                 lambda pkg: serving_packages()[pkg][1].FaultPlan.generate(
                     seed=13, n_ticks=60, n_slots=4, rate=0.3))


def test_mixed_chaos_equal_jax_engine(mixed_chaos):
    assert_chaos_equal(mixed_chaos)


def test_mixed_chaos_all_complete_equal_fault_free(mixed_chaos):
    eng, reqs, inj = mixed_chaos["torch"]
    assert inj.summary()["fired_total"] > 0
    assert_fault_free(eng, reqs)
    calm = engine("torch", n_slots=2, grain=2)
    creqs = [req("torch", rid, g, **kw) for rid, g, kw in MIXED_TRAFFIC]
    for r in creqs:
        calm.submit(r)
    calm.run()
    for a, b in zip(reqs, creqs):
        assert result_differences(a.result, b.result,
                                  SUMMARY + ("playouts", "rounds")) == []


# ---------------------------------------------------------------- quarantine ----
@pytest.fixture(scope="module")
def quarantine():
    return chaos(dict(n_slots=2, quarantine_after=2),
                 [(i, "hex", dict(seed=i)) for i in range(4)],
                 lambda pkg: events(pkg, [(t, 0, "dispatch_error")
                                          for t in range(100)]))


def test_quarantine_equal_jax_engine(quarantine):
    assert_chaos_equal(quarantine)
    je, te = quarantine["jax"][0], quarantine["torch"][0]
    assert {(k.game, s) for k, s in je.quarantined} == {
        (k.game, s) for k, s in te.quarantined}


def test_slot_quarantined_serves_on_survivor(quarantine):
    eng, reqs, _ = quarantine["torch"]
    stats = eng.stats()
    assert stats.n_quarantined == 1 and stats.n_retries >= 2
    assert_fault_free(eng, reqs)


def test_last_healthy_slot_never_quarantined():
    runs = chaos(dict(n_slots=2, quarantine_after=2, retry_backoff=(1, 2)),
                 [(f"lh{i}", "hex", dict(seed=i)) for i in range(3)],
                 lambda pkg: events(pkg, [(t, s, "dispatch_error")
                                          for t in range(8)
                                          for s in range(2)]))
    assert_chaos_equal(runs)
    eng, reqs, _ = runs["torch"]
    assert eng.stats().n_quarantined <= 1
    assert all(r.result["status"] == "answered" for r in reqs)


# ------------------------------------------------------- shedding / dedup ----
def test_bounded_admission_sheds_per_class():
    out = {}
    for pkg in PKGS:
        eng = engine(pkg, max_queue=2)
        rs = [req(pkg, f"s{i}", seed=i) for i in range(4)]
        assert eng.submit(rs[0]) and eng.submit(rs[1])
        assert not eng.submit(rs[2])
        assert rs[2].done and rs[2].result == {"status": "shed",
                                               "reason": "queue_full"}
        g = req(pkg, "g0", "gomoku", seed=1)
        assert eng.submit(g)
        eng.run(max_ticks=2000)
        assert eng.stats().n_shed == 1
        assert {r.rid for r in eng.finished} == {"s0", "s1", "g0"}
        out[pkg] = (eng, [rs[0], rs[1], rs[2], g])
    (je, jr), (te, tr) = out["jax"], out["torch"]
    assert_same_serving(je, te, jr, tr)
    assert_fault_free(te, [tr[0], tr[1], tr[3]])


def test_duplicate_submission_dropped_not_double_served():
    eng = engine("torch")
    r = req("torch", "dup", seed=2)
    assert eng.submit(r) and not eng.submit(r)
    eng.run(max_ticks=1000)
    assert len(eng.finished) == 1 and r.result["status"] == "answered"


def test_injected_duplicate_submit_is_deduped():
    runs = chaos({}, [(f"q{i}", "hex", dict(seed=i)) for i in range(2)],
                 lambda pkg: events(pkg, [(1, 0, "duplicate_submit")]),
                 max_ticks=1000)
    assert_chaos_equal(runs)
    eng, reqs, inj = runs["torch"]
    assert inj.fired.get("duplicate_submit", 0) == 1
    assert len(eng.finished) == 2
    assert all(r.result["status"] == "answered" for r in reqs)


# ------------------------------------------------------------- clock stall ----
@pytest.fixture(scope="module")
def stalled():
    return chaos({}, [("cs", "hex", dict(seed=4, deadline_s=30.0))],
                 lambda pkg: events(pkg, [(1, 0, "clock_stall", 60.0)]),
                 max_ticks=500)


def test_clock_stall_equal_jax_engine(stalled):
    assert_chaos_equal(stalled)


def test_clock_stall_expires_deadline_cleanly(stalled):
    eng, (r,), inj = stalled["torch"]
    assert inj.fired["clock_stall"] == 1
    assert r.result["status"] == "deadline_expired"
    assert 0 < r.result["rounds"] < r.result["rounds_total"]
    assert np.isfinite(r.result["root_wins"]).all()
    assert r.result["root_visits"].sum() == r.result["playouts"]


def test_chaos_builds_no_kernel(mixed_chaos, quarantine):
    """Retries replay rounds through the same kernels: the whole chaos run
    built nothing after its first quantum (here: nothing at all)."""
    before = kernel_builds()
    chaos({}, [("again", "gomoku", dict(seed=2))],
          lambda pkg: events(pkg, [(1, 0, "dispatch_error"),
                                   (2, 0, "poison_nan")]))
    assert kernel_builds() == before


# --------------------------------------------------------- exhaust detection ----
def test_run_exhaust_raises_with_unfinished_rids():
    stub = lambda tree, board, cfg, key, rnd, cp: tree
    with mock.patch("repro_torch.serve.games.run_schedule_round", stub):
        eng = engine("torch", preempt_quanta=1, tree_cap=64, guard=False)
        for i in range(3):
            eng.submit(req("torch", i, seed=i))
        with pytest.raises(RuntimeError, match="max_ticks=2 exhausted"):
            eng.run(max_ticks=2)
        with pytest.warns(RuntimeWarning, match="unfinished"):
            eng.run(max_ticks=1, on_exhaust="warn")
        assert eng.stats().n_unfinished == 3
        eng.run(on_exhaust="ignore", max_ticks=1)


# --------------------------------------------------------- chaos drain (PBT) ----
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_property_chaos_always_drains_equal_jax_engine(seed):
    """Mixed Hex and Gomoku traffic under a random fault plan: both
    engines drain, every request ends answered, shed or deadline_expired,
    the two agree on everything, and every fully-run answer equals the
    fault-free search. Deadlines (150 s) expire only through the plan's
    clock stalls (100 s each): two stalls expire one whatever the wall
    clock did, and no run takes 50 s of wall clock, so both engines see
    the same expiries."""
    rng = np.random.default_rng(seed)
    rate = float(rng.uniform(0.05, 0.4))
    grain = int(rng.integers(1, 3))
    n = int(rng.integers(4, 9))
    traffic = [(i, ("hex", "gomoku")[int(rng.integers(2))],
                dict(seed=i, deadline_s=(None if rng.random() < 0.7
                                         else 150.0)))
               for i in range(n)]
    runs = chaos(dict(n_slots=2, grain=grain, quarantine_after=3,
                      max_queue=8, retry_backoff=(1, 4)), traffic,
                 lambda pkg: serving_packages()[pkg][1].FaultPlan.generate(
                     seed=seed, n_ticks=80, n_slots=4, rate=rate,
                     stall_s=100.0), max_ticks=20_000)
    eng, reqs, _ = runs["torch"]
    assert all(r.done for r in reqs)
    assert all(r.result["status"] in ("answered", "shed", "deadline_expired")
               for r in reqs)
    assert_chaos_equal(runs)
    for r in reqs:
        if r.result["status"] != "answered":
            continue
        assert tres.validate_result(r.result, r.result["playouts"]) == []
        if r.result["rounds"] == r.result["rounds_total"]:
            ref = port_reference(eng, r)
            assert result_differences(r.result, ref, SUMMARY) == []
