"""The port's search observatory == repro.obsv.

Device counters: every ``SearchMetrics`` counter of a port search equals
the JAX package's ``stats["metrics"]`` exactly, for Hex, Gomoku, a
3-member forest, two virtual-loss rounds and a warm search started from a
JAX tree carried over with ``convert``; the counter primitives equal the
JAX ones on seeded random inputs (masked lanes, a forest's members); a
search with metrics on is bit-identical to the same search with metrics
off. Host plane: the trace recorder's spans on a traced port search match
the JAX package's, ``CompileWatch`` counts kernel-library builds, and the
registry and the dispatch fit give the JAX package's numbers.
"""

import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gscpm as jg
from repro.core import root_parallel as jrp
from repro.core import tree as jt
from repro.obsv import MetricsRegistry as JMetricsRegistry
from repro.obsv import TraceRecorder as JTraceRecorder
from repro.obsv import profile as jprofile
from repro.obsv import search_metrics as jsm
from repro_torch import convert, parity, rng
from repro_torch.core import gscpm as tg
from repro_torch.core import root_parallel as trp
from repro_torch.kernels import _build
from repro_torch.obsv import (MetricsRegistry, TraceRecorder,
                              init_search_metrics, init_search_metrics_forest,
                              merge_metrics, summarize_metrics, validate_trace)
from repro_torch.obsv import profile as tprofile
from repro_torch.obsv import search_metrics as tsm
from torch_parity_util import jax_tree_fields

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)


def kw_for(game="hex", size=5, **over):
    return {**dict(game=game, board_size=size, n_workers=8, n_tasks=32,
                   n_playouts=256, tree_cap=1024, metrics=True), **over}


def differing(t, j) -> list[str]:
    got, want = convert.tree_to_numpy(t), jax_tree_fields(j)
    return [k for k in want if got[k].dtype != want[k].dtype
            or not np.array_equal(got[k], want[k])]


def board_for(kw):
    n = kw["board_size"] ** 2
    return np.zeros(n, np.int8)


# ------------------------------------------------ counters against the JAX ----
CASES = {
    "hex": kw_for(),
    "gomoku": kw_for("gomoku", 7),
    "vl_rounds_2": kw_for(size=4, vl_rounds=2),
    "deep": kw_for(size=4),
    "masked_lanes": kw_for(n_tasks=6, n_playouts=240),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_equal_reference(case):
    kw = CASES[case]
    board = board_for(kw)
    jtree, jst = jg.gscpm_search(jnp.asarray(board), 1, jg.GSCPMConfig(**kw),
                                 jax.random.key(3))
    ttree, tst = tg.gscpm_search(torch.from_numpy(board), 1,
                                 tg.GSCPMConfig(**kw), rng.key(3, "cpu"),
                                 device="cpu")
    assert differing(ttree, jtree) == []
    assert tst["metrics"] == jst["metrics"]
    m = tst["metrics"]
    assert m["lane_playouts"] == tst["playouts"]
    assert m["expansions"] == tst["tree_nodes"] - 1
    if case in ("vl_rounds_2", "deep"):
        assert m["held_levels"] > 0     # lanes of a group at unequal depths
    if case == "masked_lanes":
        assert m["masked_lane_iterations"] > 0


def test_forest_counters_equal_reference():
    kw = kw_for(n_workers=4, n_tasks=8, n_playouts=96)
    board = board_for(kw)
    jf, jst = jrp.gscpm_search_batch(jnp.asarray(board), 1,
                                     jg.GSCPMConfig(**kw), jax.random.key(5),
                                     n_trees=3, shard="off")
    tf, tst = trp.gscpm_search_batch(torch.from_numpy(board), 1,
                                     tg.GSCPMConfig(**kw), rng.key(5, "cpu"),
                                     n_trees=3, device="cpu")
    assert differing(tf, jf) == []
    assert tst["metrics"] == jst["metrics"]
    assert tst["metrics"]["lane_playouts"] == tst["playouts"]


@pytest.mark.parametrize("forest", [False, True], ids=["tree", "forest"])
def test_warm_search_counters_equal_reference(forest):
    """A warm search from a JAX tree (or forest) re-rooted after a move:
    ``tree_nodes_reused`` is seeded from the warm tree and every counter
    equals the JAX package's (its warm fields are read before its search,
    which donates them)."""
    kw = kw_for(n_workers=4, n_tasks=8, n_playouts=128, metrics=False)
    jcfg = jg.GSCPMConfig(**kw)
    if forest:
        jf, st = jrp.gscpm_search_batch(jnp.zeros(25, jnp.int8), 1, jcfg,
                                        jax.random.key(2), n_trees=3,
                                        shard="off")
        mv = st["best_move_sum"]
        jwarm = jt.reroot_forest(jf, mv)
    else:
        jtree, st = jg.gscpm_search(jnp.zeros(25, jnp.int8), 1, jcfg,
                                    jax.random.key(2))
        mv = st["best_move"]
        jwarm = jt.reroot_tree(jtree, mv)
    fields = jax_tree_fields(jwarm)
    board = np.zeros(25, np.int8)
    board[mv] = 1
    on = dict(kw, metrics=True)
    if forest:
        jout, jst = jrp.gscpm_search_batch(
            jnp.asarray(board), 2, jg.GSCPMConfig(**on), jax.random.key(4),
            forest=jwarm, shard="off")
        tout, tst = trp.gscpm_search_batch(
            torch.from_numpy(board), 2, tg.GSCPMConfig(**on),
            rng.key(4, "cpu"), forest=convert.forest_from_numpy(fields, "cpu"),
            device="cpu")
    else:
        jout, jst = jg.gscpm_search(jnp.asarray(board), 2,
                                    jg.GSCPMConfig(**on), jax.random.key(4),
                                    tree=jwarm)
        tout, tst = tg.gscpm_search(torch.from_numpy(board), 2,
                                    tg.GSCPMConfig(**on), rng.key(4, "cpu"),
                                    tree=convert.tree_from_numpy(fields, "cpu"),
                                    device="cpu")
    assert differing(tout, jout) == []
    assert tst["metrics"] == jst["metrics"]
    reused = int(np.asarray(fields["n_nodes"]).sum()) - (3 if forest else 1)
    assert tst["metrics"]["tree_nodes_reused"] == reused > 0


# ------------------------------------------- primitives on random inputs ----
def _random_iteration(seed, E, R, Wr, n_cells=25, cap=64):
    """Seeded observations of one sync iteration ((E,) leading axis when
    E > 0), with masked lanes, duplicate leaves and duplicate proposals."""
    r = np.random.default_rng(seed)
    lead = (E,) if E else ()
    W = R * Wr
    depths = r.integers(0, 5, (*lead, R, Wr)).astype(np.int32)
    active = r.random((*lead, W)) < 0.7
    leaves = r.integers(0, 6, (*lead, W)).astype(np.int32)
    moves = r.integers(-1, 4, (*lead, W)).astype(np.int32)
    boards = r.integers(0, 3, (*lead, W, n_cells)).astype(np.int8)
    n_before = r.integers(1, cap // 2, lead).astype(np.int32)
    n_after = (n_before + r.integers(0, 5, lead)).astype(np.int32)
    return dict(depths_grouped=depths, active=active, leaves=leaves,
                moves=moves, eval_boards=boards, n_nodes_before=n_before,
                n_nodes_after=n_after)


def _host(m) -> dict:
    return {f: np.asarray(v).tolist() for f, v in zip(m._fields, m)}


@pytest.mark.parametrize("E,R,Wr", [(0, 1, 8), (0, 2, 4), (0, 4, 2),
                                    (3, 1, 6), (3, 2, 3)])
def test_accumulate_iteration_equals_reference(E, R, Wr):
    """Two iterations folded in on seeded random inputs (masked lanes,
    colliding leaves and proposals); on a forest the JAX function runs
    under vmap over members, as the JAX forest chunk runs it."""
    jm = (jsm.init_search_metrics_forest(E) if E
          else jsm.init_search_metrics())
    tm = (init_search_metrics_forest(E, "cpu") if E
          else init_search_metrics(device="cpu"))
    jacc = (jax.vmap(lambda m, **kw: jsm.accumulate_iteration(m, **kw))
            if E else jsm.accumulate_iteration)
    for seed in (0, 1):
        obs = _random_iteration(seed + 10 * E + R, E, R, Wr)
        jm = jacc(jm, **{k: jnp.asarray(v) for k, v in obs.items()})
        tm = tsm.accumulate_iteration(
            tm, **{k: torch.from_numpy(np.asarray(v)) for k, v in obs.items()})
    assert _host(tm) == _host(jm)
    assert all(x.dtype == torch.int32 for x in tm)
    assert tsm.summarize_metrics(tm) == jsm.summarize_metrics(jm)


def test_all_masked_iteration_leaves_the_gauges_at_zero():
    obs = _random_iteration(4, 0, 2, 4)
    obs["active"] = np.zeros_like(obs["active"])
    m = tsm.accumulate_iteration(
        init_search_metrics(device="cpu"),
        **{k: torch.from_numpy(np.asarray(v)) for k, v in obs.items()})
    assert int(m.depth_max) == int(m.playout_len_max) == 0
    assert int(m.lane_playouts) == 0 and int(m.masked_lane_iterations) == 8
    assert int(m.leaf_collisions) == int(m.expand_collisions) == 0


@pytest.mark.parametrize("E", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_duplicate_counts_equal_reference(E, seed):
    """Masked lanes get unique sentinels (also across members); duplicates
    are counted per member over the (leaf, move) order."""
    r = np.random.default_rng(seed)
    lead = (E,) if E else ()
    W = 16
    leaves = r.integers(0, 4, (*lead, W)).astype(np.int32)
    moves = r.integers(0, 3, (*lead, W)).astype(np.int32)
    mask = r.random((*lead, W)) < 0.6
    jpair = (jax.vmap(jsm._pair_dup_count) if E else jsm._pair_dup_count)
    jsort = (jax.vmap(jsm._sorted_dup_count) if E else jsm._sorted_dup_count)
    t = lambda a: torch.from_numpy(a)
    got = tsm._pair_dup_count(t(leaves), t(moves), t(mask))
    assert got.tolist() == np.asarray(jpair(jnp.asarray(leaves),
                                            jnp.asarray(moves),
                                            jnp.asarray(mask))).tolist()
    got = tsm._sorted_dup_count(t(leaves), t(mask))
    assert got.tolist() == np.asarray(jsort(jnp.asarray(leaves),
                                            jnp.asarray(mask))).tolist()


def test_masked_lanes_of_two_members_never_match():
    leaves = torch.zeros((2, 4), dtype=torch.int32)
    mask = torch.zeros((2, 4), dtype=torch.bool)
    assert tsm._sorted_dup_count(leaves, mask).tolist() == [0, 0]
    assert tsm._pair_dup_count(leaves, leaves, mask).tolist() == [0, 0]
    mask[:, :2] = True            # one duplicate inside each member only
    assert tsm._sorted_dup_count(leaves, mask).tolist() == [1, 1]
    assert tsm._pair_dup_count(leaves, leaves, mask).tolist() == [1, 1]


# ------------------------------------------------------------ bit-identity ----
@pytest.mark.parametrize("game,size", [("hex", 5), ("gomoku", 5)])
def test_metrics_whole_search_bit_identity(game, size):
    cfg = tg.GSCPMConfig(**kw_for(game, size, metrics=False))
    board = torch.zeros(size * size, dtype=torch.int8)
    key = rng.key(7, "cpu")
    t_off, s_off = tg.gscpm_search(board, 1, cfg, key, device="cpu")
    t_on, s_on = tg.gscpm_search(board, 1, dataclasses.replace(
        cfg, metrics=True), key, device="cpu")
    assert parity.differing_fields(t_off, t_on) == []
    assert s_off["best_move"] == s_on["best_move"]
    assert "metrics" in s_on and "metrics" not in s_off


@pytest.mark.parametrize("game,size", [("hex", 5), ("gomoku", 5)])
def test_metrics_forest_bit_identity(game, size):
    cfg = tg.GSCPMConfig(**kw_for(game, size, metrics=False, n_workers=4,
                                  n_tasks=8, n_playouts=32))
    board = torch.zeros(size * size, dtype=torch.int8)
    key = rng.key(3, "cpu")
    f_off, s_off = trp.gscpm_search_batch(board, 1, cfg, key, n_trees=3,
                                          device="cpu")
    f_on, s_on = trp.gscpm_search_batch(board, 1, dataclasses.replace(
        cfg, metrics=True), key, n_trees=3, device="cpu")
    assert parity.differing_fields(f_off, f_on) == []
    assert s_on["metrics"]["lane_playouts"] == s_off["playouts"]


def test_metrics_off_runs_nothing_extra():
    """With the flag off the iteration never reaches the counter module."""
    cfg = tg.GSCPMConfig(**kw_for(metrics=False, n_playouts=32))
    with mock.patch.object(tg, "accumulate_iteration",
                           side_effect=AssertionError("called")):
        tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1, cfg,
                        rng.key(0, "cpu"), device="cpu")


# ------------------------------------------------------- merge and summary ----
def test_merge_metrics_sum_vs_max_fields():
    z = init_search_metrics(device="cpu")
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    a = z._replace(expansions=i32(3), tree_nodes_peak=i32(10), depth_max=i32(2))
    b = z._replace(expansions=i32(4), tree_nodes_peak=i32(8), depth_max=i32(5))
    c = merge_metrics(a, b)
    assert int(c.expansions) == 7
    assert int(c.tree_nodes_peak) == 10 and int(c.depth_max) == 5
    jz = jsm.init_search_metrics()
    jc = jsm.merge_metrics(
        jz._replace(expansions=jnp.int32(3), tree_nodes_peak=jnp.int32(10),
                    depth_max=jnp.int32(2)),
        jz._replace(expansions=jnp.int32(4), tree_nodes_peak=jnp.int32(8),
                    depth_max=jnp.int32(5)))
    assert _host(c) == _host(jc)


def test_forest_summary_merges_members():
    fm = init_search_metrics_forest(3, "cpu")
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    fm = fm._replace(lane_playouts=i32([4, 5, 6]), depth_max=i32([2, 7, 3]),
                     depth_sum=i32([1, 2, 3]))
    s = summarize_metrics(fm)
    assert s["lane_playouts"] == 15
    assert s["depth_max"] == 7                      # max-merged gauge
    assert s["depth_sum"] == 6                      # summed counter
    jfm = jsm.init_search_metrics_forest(3)._replace(
        lane_playouts=jnp.asarray([4, 5, 6], jnp.int32),
        depth_max=jnp.asarray([2, 7, 3], jnp.int32),
        depth_sum=jnp.asarray([1, 2, 3], jnp.int32))
    assert s == jsm.summarize_metrics(jfm)


# ------------------------------------------------------- flag/accumulator ----
def test_run_chunk_rejects_flag_accumulator_mismatch():
    cfg = tg.GSCPMConfig(**kw_for(metrics=False))
    board = torch.zeros(25, dtype=torch.int8)
    tree = tg.init_tree(cfg.tree_cap, 25, 1, device="cpu")
    keys = rng.fold_in(rng.key(0, "cpu"), torch.arange(cfg.n_workers,
                                                        dtype=torch.int32))
    active = torch.ones(cfg.n_workers, dtype=torch.bool)
    with pytest.raises(ValueError, match="metrics"):
        tg.run_chunk(tree, board, cfg, keys, active, 1, 1.0,
                     init_search_metrics(device="cpu"))
    with pytest.raises(ValueError, match="metrics"):
        tg.run_chunk(tree, board, dataclasses.replace(cfg, metrics=True),
                     keys, active, 1, 1.0)
    f = trp.init_forest(2, cfg.tree_cap, 25, 1, device="cpu")
    with pytest.raises(ValueError, match="metrics"):
        trp.run_chunk_forest(f, board.expand(2, -1), cfg,
                             keys.expand(2, -1, -1), active.expand(2, -1), 1,
                             1.0, init_search_metrics_forest(2, "cpu"))


# ------------------------------------------------------------------ tracer ----
def _span_args(events):
    return [e["args"] for e in events if e["name"] == "gscpm_round"]


@pytest.mark.parametrize("forest", [False, True], ids=["tree", "forest"])
def test_traced_search_spans_equal_reference(forest, tmp_path):
    """One ``gscpm_round`` span per schedule round with the JAX package's
    args; the trace validates and survives a save."""
    kw = kw_for(metrics=False, n_workers=4, n_tasks=12, n_playouts=48)
    board = np.zeros(25, np.int8)
    tr, jtr = TraceRecorder(), JTraceRecorder()
    if forest:
        trp.gscpm_search_batch(torch.from_numpy(board), 1,
                               tg.GSCPMConfig(**kw), rng.key(0, "cpu"),
                               n_trees=2, tracer=tr, device="cpu")
        jrp.gscpm_search_batch(jnp.asarray(board), 1, jg.GSCPMConfig(**kw),
                               jax.random.key(0), n_trees=2, tracer=jtr,
                               shard="off")
    else:
        tg.gscpm_search(torch.from_numpy(board), 1, tg.GSCPMConfig(**kw),
                        rng.key(0, "cpu"), tracer=tr, device="cpu")
        jg.gscpm_search(jnp.asarray(board), 1, jg.GSCPMConfig(**kw),
                        jax.random.key(0), tracer=jtr)
    spans = _span_args(tr.events)
    assert spans == _span_args(jtr.events) and len(spans) == 3
    assert all(e["dur"] >= 0 for e in tr.events if e["ph"] == "X")
    n = validate_trace(tr.to_dict())
    path = tr.save(str(tmp_path / "t.json"))
    assert validate_trace(path) == n == len(tr.events)
    with open(path) as f:
        assert json.load(f)["displayTimeUnit"] == "ms"


def test_trace_recorder_structure_and_validation():
    tr = TraceRecorder(process_name="t")
    tr.name_thread(1, "worker")
    tr.instant("evt", {"k": 1})
    tr.begin("outer", tid=1)
    tr.end(tid=1)
    with tr.span("quantum", {"rounds": 2}):
        pass
    tr.counter("queue", {"depth": 3})
    assert validate_trace(tr.to_dict()) == len(tr.events) >= 6
    assert [e["ph"] for e in tr.events] == ["M", "M", "i", "B", "E", "X", "C"]
    with pytest.raises(ValueError, match="traceEvents"):
        validate_trace({"traceEvents": []})
    with pytest.raises(ValueError, match="missing"):
        validate_trace({"traceEvents": [{"ph": "i", "ts": 0}]})
    with pytest.raises(ValueError, match="dur"):
        validate_trace({"traceEvents": [{"name": "x", "ph": "X", "ts": 0}]})
    with pytest.raises(ValueError, match="unclosed"):
        validate_trace({"traceEvents": [{"name": "b", "ph": "B", "ts": 0}]})
    with pytest.raises(ValueError, match="unbalanced"):
        validate_trace({"traceEvents": [{"name": "e", "ph": "E", "ts": 0}]})


def test_compile_watch_counts_kernel_builds():
    """The watch reads the kernel library's build counter (mocked here: no
    nvcc on this machine); a build between polls is one ``jit_compile``
    instant, and a traced search that builds nothing records none."""
    with mock.patch.object(_build, "builds", 0):
        tr = TraceRecorder()
        tr.watch_compiles("kernels")
        tr.poll_compiles()
        assert [e for e in tr.events if e["name"] == "jit_compile"] == []
        _build.builds += 2                 # two builds since the last poll
        tr.poll_compiles()
        assert tr.compile_counts() == {"kernels": 2}
        evs = [e for e in tr.events if e["name"] == "jit_compile"]
        assert len(evs) == 1 and evs[0]["args"] == {
            "fn": "kernels", "new_programs": 2, "total": 2}
        tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1,
                        tg.GSCPMConfig(**kw_for(metrics=False,
                                                n_playouts=32)),
                        rng.key(0, "cpu"), tracer=tr, device="cpu")
        assert tr.compile_counts() == {"kernels": 2}
    counts = iter([5, 5, 7, 7])
    tr = TraceRecorder()
    tr.watch_compiles("probe", lambda: next(counts))
    tr.poll_compiles()
    tr.poll_compiles()
    assert tr.compile_counts() == {"probe": 2}


# ---------------------------------------------------------------- registry ----
def test_metrics_registry_equals_reference(tmp_path):
    regs = (MetricsRegistry(), JMetricsRegistry())
    for reg in regs:
        reg.counter("requests_total", "all requests").inc()
        reg.counter("requests_total").inc(2)
        reg.gauge("depth").set(7)
        reg.gauge("ratio", "a share").set(0.25)
        with pytest.raises(ValueError, match="registered"):
            reg.gauge("requests_total")
    assert regs[0].exposition() == regs[1].exposition()
    snaps = [r.snapshot()["metrics"] for r in regs]
    assert snaps[0] == snaps[1]
    assert snaps[0]["requests_total"]["value"] == 3
    assert "requests_total 3" in regs[0].exposition()
    path = regs[0].save(str(tmp_path / "m.json"))
    with open(path) as f:
        assert json.load(f)["metrics"]["depth"]["value"] == 7


# ----------------------------------------------------------------- profile ----
def _synthetic_trace(points, t_round_us, t_iter_us, workers=8):
    """X spans with dur = rounds*t_round + rounds*m*workers*t_iter."""
    evs, ts = [], 0.0
    for rounds, m in points:
        iters = rounds * m
        dur = rounds * t_round_us + iters * workers * t_iter_us
        evs.append({"name": "gscpm_round", "ph": "X", "pid": 0, "tid": 0,
                    "ts": ts, "dur": dur,
                    "args": {"rounds": rounds, "iterations": iters,
                             "workers": workers}})
        ts += dur + 10.0
    return {"traceEvents": evs}


def _tainted():
    trace = _synthetic_trace([(4, 2), (2, 16), (8, 1), (1, 64), (16, 4)],
                             t_round_us=500.0, t_iter_us=2.0, workers=8)
    first = trace["traceEvents"][0]
    first["dur"] += 3_000_000.0                # a 3 s build stall
    trace["traceEvents"].append(
        {"name": "jit_compile", "ph": "i", "s": "t", "pid": 0, "tid": 0,
         "ts": first["ts"] + 1.0, "args": {"fn": "kernels"}})
    return trace


PROFILE_TRACES = {
    "identifiable": lambda: _synthetic_trace(
        [(4, 2), (2, 16), (8, 1), (1, 64), (16, 4)], 500.0, 2.0, workers=8),
    "rank_deficient": lambda: _synthetic_trace([(2, 8), (4, 8), (8, 8)],
                                               100.0, 1.0),
    "tainted": _tainted,
    "noisy": lambda: {"traceEvents": [
        dict(e, dur=e["dur"] * f) for e, f in zip(_synthetic_trace(
            [(1, 256), (4, 64), (16, 16), (2, 128)], 300.0, 5.0,
            workers=256)["traceEvents"], (1.03, 0.97, 1.05, 0.99))]},
}


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=1e-9, abs=1e-15)
    return a == b


@pytest.mark.parametrize("name", sorted(PROFILE_TRACES))
def test_fit_dispatch_profile_equals_reference(name):
    trace = PROFILE_TRACES[name]()
    got = tprofile.fit_dispatch_profile(json.loads(json.dumps(trace)))
    want = jprofile.fit_dispatch_profile(json.loads(json.dumps(trace)))
    assert got.keys() == want.keys()
    assert all(_close(got[k], want[k]) for k in want), (got, want)
    m = tprofile.measured_dag_model(got)
    w = jprofile.measured_dag_model(want)
    assert all(_close(getattr(m, f), getattr(w, f))
               for f in ("t_iter", "t_spawn", "t_round"))


def test_measured_vs_analytic_and_format_table_equal_reference():
    trace = _synthetic_trace([(4, 2), (1, 64)], 500.0, 2.0)
    rows = {}
    for mod in (tprofile, jprofile):
        rows[mod] = mod.measured_vs_analytic(
            mod.fit_dispatch_profile(trace), n_playouts=256,
            task_counts=(8, 64, 1024), n_cores=61)
    for a, b in zip(rows[tprofile], rows[jprofile]):
        assert a.keys() == b.keys()
        assert all(_close(a[k], b[k]) for k in b)
    assert (tprofile.format_table(rows[tprofile])
            == jprofile.format_table(rows[jprofile]))
    assert len(tprofile.format_table(rows[tprofile]).splitlines()) == 5


def test_profile_requires_dispatch_spans():
    with pytest.raises(ValueError, match="dispatch spans"):
        tprofile.fit_dispatch_profile({"traceEvents": [
            {"name": "tick", "ph": "X", "ts": 0, "dur": 1}]})


def test_traced_port_search_gives_a_fittable_profile():
    tr = TraceRecorder()
    cfg = tg.GSCPMConfig(**kw_for(metrics=False, n_playouts=32))
    for n_t in (4, 8, 16):
        tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1,
                        dataclasses.replace(cfg, n_tasks=n_t),
                        rng.key(0, "cpu"), tracer=tr, device="cpu")
    prof = tprofile.fit_dispatch_profile(tr, n_workers=cfg.n_workers)
    assert prof["n_spans"] == 1 + 1 + 2 and prof["n_excluded_compile"] == 0
    assert prof["t_sync_iter_s"] > 0.0 and prof["t_iter_s"] > 0.0
    assert tprofile.load_events(tr) == tr.events


# ---------------------------------------------------------------- launcher ----
def _normalized(out: str) -> list[str]:
    """The launcher's lines without its timings and device suffix."""
    import re
    lines = []
    for ln in out.splitlines():
        ln = re.sub(r" in [0-9.]+s \([0-9]+/s, ", " (", ln)
        lines.append(re.sub(r" on cpu$", "", ln))
    return lines


@pytest.mark.parametrize("flags", [
    ["--moves", "2"], ["--trees", "2", "--moves", "2"],
    ["--game", "gomoku", "--moves", "2"],
    ["--trees", "2", "--moves", "2", "--scheduler", "rebalance", "--cold"]],
    ids=["hex", "forest", "gomoku", "forest-rebalance-cold"])
def test_launcher_equals_reference(flags, capsys, monkeypatch):
    """``repro_torch.launch.search --metrics`` prints the JAX launcher's
    lines at 5x5 — moves, visit-sum and vote, member values, reused nodes
    and the device counters — apart from the timings."""
    import sys

    from repro.launch import search as jsearch
    from repro_torch.launch import search as tsearch
    argv = ["--size", "5", "--playouts", "128", "--tasks", "8",
            "--workers", "8", "--metrics", *flags]
    monkeypatch.setattr(sys, "argv", ["repro.launch.search", *argv])
    jsearch.main()
    want = _normalized(capsys.readouterr().out)
    st = tsearch.main([*argv, "--device", "cpu"])
    got = _normalized(capsys.readouterr().out)
    assert got == want
    assert sum("device metrics" in ln for ln in got) == 2
    assert len(st["moves_played"]) == 2
