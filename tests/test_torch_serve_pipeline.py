"""Pipelined retirement in the port's engine (DESIGN.md §18), against the
JAX package's engine and against the port's own blocking mode.

The scenarios are those of ``tests/test_pipeline.py`` at 5x5, 4 workers
and ``tree_cap=512``: pipelined answers equal blocking ones (and the JAX
engine's), the deferred retirements drain, pipelining switches itself off
under observers and chaos, ``device_wait_s`` is accounted, and a forest
tenant (``n_trees > 1``) equals ``gscpm_search_batch``. On the CPU a
deferred summary is a plain copy (the card's is a pinned, non-blocking
copy behind an event, which ``chip_smoke.py``'s ``serve_games`` phase
drives).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_parity_util import (FOREST_FIELDS, RESULT_FIELDS,
                               assert_same_serving, make_engine,
                               result_differences, serving_packages)

from repro_torch import rng
from repro_torch.core.root_parallel import (gscpm_search_batch,
                                            merged_root_stats)
from repro_torch.core.tree import init_tree
from repro_torch.obsv import TraceRecorder
from repro_torch.obsv.trace import kernel_builds
from repro_torch.serve.resilience import FaultInjector, FaultPlan

torch.set_num_threads(1)

SIZE = 5
CAP = 512
PKGS = ("jax", "torch")


def engine(pkg="torch", pipeline=None, n_slots=2, **kw):
    return make_engine(pkg, n_slots=n_slots, grain=2, preempt_quanta=2,
                       n_workers=4, tree_cap=CAP, pipeline=pipeline, **kw)


def mix(pkg, n=6):
    games, _ = serving_packages()[pkg]
    return [games.GameRequest(rid=i, game=["hex", "gomoku"][i % 2],
                              board_size=SIZE, n_playouts=48 + 16 * (i % 3),
                              n_tasks=8, seed=i) for i in range(n)]


def run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


@pytest.fixture(scope="module")
def runs():
    """The same six-request mix: the JAX engine pipelined, the port
    pipelined and blocking."""
    return {"jax": run(engine("jax", pipeline=True), mix("jax")),
            "torch": run(engine("torch", pipeline=True), mix("torch")),
            "blocking": run(engine("torch", pipeline=False), mix("torch"))}


def test_pipelined_equal_jax_engine(runs):
    (je, jr), (te, tr) = runs["jax"], runs["torch"]
    assert je.pipeline is te.pipeline is True
    assert_same_serving(je, te, jr, tr)


@pytest.mark.parametrize("rid", range(6))
def test_pipelined_equal_blocking(runs, rid):
    (pe, pr), (be, br) = runs["torch"], runs["blocking"]
    assert be.pipeline is False
    assert result_differences(pr[rid].result, br[rid].result,
                              RESULT_FIELDS) == []


def test_pipelined_and_blocking_schedule_alike(runs):
    (pe, _), (be, _) = runs["torch"], runs["blocking"]
    assert pe.admission_order == be.admission_order
    assert pe.stats().quanta == be.stats().quanta
    assert pe.stats().n_preemptions == be.stats().n_preemptions


def test_pipelined_default_on_and_drains_pending():
    eng = engine()
    assert eng.pipeline is True
    run(eng, mix("torch", n=5))
    assert not eng._pending_retire and not eng.has_work()
    assert len(eng.finished) == 5
    assert all(r.result["status"] == "answered" for r in eng.finished)


def test_deferred_rid_is_still_pending():
    """A duplicate of a request whose retirement is deferred must not be
    served twice."""
    eng = engine()
    (r,) = mix("torch", n=1)
    eng.submit(r)
    while not eng._pending_retire:
        eng._tick()
    assert eng.has_work() and not eng.submit(r)
    eng.run()
    assert len(eng.finished) == 1


def test_deferred_summary_is_a_copy_on_the_cpu():
    """On the CPU ``_stage_summary`` copies (``tree_nodes`` is the tree's
    own counter, which the search updates in place) and has no event."""
    eng = engine()
    tree = init_tree(16, 25, 1, device="cpu")
    host, copied = eng._stage_summary({"tree_nodes": tree.n_nodes,
                                       "root_visits": tree.visits[:3]})
    assert copied is None
    tree.n_nodes.add_(5)
    tree.visits[0] = 7.0
    assert int(host["tree_nodes"]) == 1 and float(host["root_visits"][0]) == 0


# ------------------------------------------------------------- auto-disable ----
def test_pipeline_auto_disables_under_observers_and_chaos():
    assert engine(pipeline=True, tracer=TraceRecorder()).pipeline is False
    inj = FaultInjector(FaultPlan.generate(seed=1, n_ticks=10, n_slots=2,
                                           rate=0.1))
    assert engine(pipeline=True, injector=inj).pipeline is False
    assert engine(pipeline=True, snapshots=True).pipeline is False
    assert engine(pipeline=True).pipeline is True
    assert engine(pipeline=False).pipeline is False


# --------------------------------------------------------- device accounting ----
@pytest.mark.parametrize("pipeline", [False, True])
def test_device_wait_recorded_in_stats(pipeline):
    eng, _ = run(engine(pipeline=pipeline), mix("torch", n=3))
    qs = eng.stats()
    assert qs.device_wait_s > 0.0
    assert qs.as_dict()["device_wait_s"] == eng.device_wait_s


def test_pipelined_builds_no_kernel():
    before = kernel_builds()
    run(engine(pipeline=True), mix("torch", n=4))
    assert kernel_builds() == before


# -------------------------------------------------------------- forest tenant ----
def forest_req(pkg, rid=0, **kw):
    games, _ = serving_packages()[pkg]
    kw = {**dict(n_playouts=48, n_tasks=8, seed=3), **kw}
    return games.GameRequest(rid=rid, game="hex", board_size=SIZE,
                             n_trees=3, **kw)


@pytest.fixture(scope="module")
def forest():
    return {pkg: run(engine(pkg), [forest_req(pkg)]) for pkg in PKGS}


def test_forest_request_equal_jax_engine(forest):
    (je, jr), (te, tr) = forest["jax"], forest["torch"]
    assert_same_serving(je, te, jr, tr)
    assert result_differences(jr[0].result, tr[0].result,
                              FOREST_FIELDS) == []


def test_forest_request_matches_batch_search(forest):
    eng, (r,) = forest["torch"]
    res = r.result
    assert res["n_trees"] == 3 and res["playouts"] == 3 * 48
    cfg = eng.request_cfg(r)
    board = cfg.game_obj.init_board("cpu")
    fst, stats = gscpm_search_batch(board, 1, cfg, rng.key(3, "cpu"),
                                    n_trees=3, device="cpu")
    mv, mw = merged_root_stats(fst, SIZE * SIZE)
    np.testing.assert_array_equal(res["root_visits"], mv.numpy())
    np.testing.assert_array_equal(res["root_wins"], mw.numpy())
    assert res["best_move"] == stats["best_move_sum"]
    assert res["best_move_vote"] == stats["best_move_vote"]
    assert res["member_best_moves"] == stats["member_best_moves"]
    assert res["tree_nodes"] == sum(stats["tree_nodes"])


def test_forest_requests_with_metrics_and_preemption_equal_jax_engine():
    """Two forest tenants of one class on one slot, preempted between
    quanta, with the device counters on."""
    out = {}
    for pkg in PKGS:
        eng = engine(pkg, n_slots=1, metrics=True)
        out[pkg] = run(eng, [
            forest_req(pkg, rid=0, n_playouts=96, n_tasks=32),
            forest_req(pkg, rid=1, n_playouts=64, n_tasks=16, cp=0.6)])
    (je, jr), (te, tr) = out["jax"], out["torch"]
    assert_same_serving(je, te, jr, tr)
    assert te.stats().n_preemptions > 0
    assert tr[0].result["metrics"]["lane_playouts"] == 3 * 96


@pytest.mark.parametrize("bad", [dict(n_trees=0), dict(n_trees=True),
                                 dict(n_trees=2.0),
                                 dict(n_trees=2, session=object())],
                         ids=["zero", "bool", "float", "session"])
def test_forest_request_rejects_sessions_and_bad_widths(bad):
    errs = []
    for pkg in PKGS:
        games, _ = serving_packages()[pkg]
        eng = engine(pkg)
        with pytest.raises(ValueError) as info:
            eng.submit(games.GameRequest(rid=1, game="hex", board_size=SIZE,
                                         n_playouts=16, n_tasks=8, seed=0,
                                         **bad))
        errs.append(str(info.value))
    assert errs[0] == errs[1]


def test_forest_class_is_its_own_pool():
    games, _ = serving_packages()["torch"]
    eng = engine()
    single = games.GameRequest(rid=1, game="hex", board_size=SIZE)
    assert eng.request_cfg(forest_req("torch")) != eng.request_cfg(single)
    run(eng, [forest_req("torch"), single])
    assert sorted(ck.n_trees for ck in eng.pools) == [1, 3]
