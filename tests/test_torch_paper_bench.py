"""The port's paper experiments (``benchmarks_torch``) == the JAX package's.

The analytic model (``core/cilkview.py``, Fig 5) equals the JAX package's
at every point of the paper's task sweep; the Fig 7 sweep and the
virtual-loss ablation run the same searches as their JAX twins (the same
trees: node counts, masked-lane fractions, best moves; rates are not
compared); the configuration of the paper's experiment is the JAX
package's; the aggregator refuses the jobs that wait for other items.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

# the two benchmark packages live at the root of the checkout
ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import ablate_vloss as jablate  # noqa: E402
from benchmarks import fig5_cilkview as jfig5  # noqa: E402
from benchmarks import fig7_speedup as jfig7  # noqa: E402
from benchmarks_torch import (ablate_vloss, fig5_cilkview, fig7_speedup,  # noqa: E402
                              fig9_mapping, root_parallel, run,
                              table2_sequential)
from repro.configs import hex_paper as jpaper  # noqa: E402
from repro.core import cilkview as jcv  # noqa: E402
from repro.core import gscpm as jg  # noqa: E402
from repro_torch.configs import hex_paper as tpaper  # noqa: E402
from repro_torch.core import cilkview as tcv  # noqa: E402

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

CORES = (1, 16, 61, 244, 256)
MODELS = [dict(), dict(t_spawn=0.05, t_round=3.0), dict(t_iter=2.0,
                                                        t_round=0.5)]


@pytest.mark.parametrize("model", range(len(MODELS)))
def test_cilkview_equals_reference_at_every_sweep_point(model):
    tm = tcv.DagModel(**MODELS[model])
    jm = jcv.DagModel(**MODELS[model])
    n = tpaper.PAPER.n_playouts
    for t in tpaper.TASK_SWEEP:
        g = max(1, n // t)
        assert tcv.work(t, g, tm) == jcv.work(t, g, jm)
        assert tcv.span(t, g, tm) == jcv.span(t, g, jm)
        assert tcv.parallelism(t, g, tm) == jcv.parallelism(t, g, jm)
        for p in CORES:
            assert tcv.speedup_bound(t, g, p, tm) == jcv.speedup_bound(
                t, g, p, jm)
            assert tcv.burdened_span(t, g, p, tm) == jcv.burdened_span(
                t, g, p, jm)
            assert (tcv.burdened_parallelism(t, g, p, tm)
                    == jcv.burdened_parallelism(t, g, p, jm))
    assert (tcv.profile(n, tpaper.TASK_SWEEP, list(CORES), tm)
            == jcv.profile(n, jpaper.TASK_SWEEP, list(CORES), jm))


def test_fig5_equals_reference():
    got = fig5_cilkview.run()
    assert got.pop("device") is None            # analytic: no device
    assert got == jfig5.run()
    assert got == {**jfig5.run(tpaper.PAPER.n_playouts)}


def test_paper_config_equals_reference():
    for name in ("PAPER", "PAPER_CPU"):
        t, j = getattr(tpaper, name), getattr(jpaper, name)
        fields = [f.name for f in dataclasses.fields(j)]
        assert [f.name for f in dataclasses.fields(t)] == fields
        assert all(getattr(t, f) == getattr(j, f) for f in fields), name
        assert t.grain == j.grain
    assert tpaper.TASK_SWEEP == jpaper.TASK_SWEEP


FIG7 = dict(n_playouts=256, n_workers=8, board_size=5, task_sweep=(4, 32),
            repeats=1)


@pytest.fixture(scope="module")
def fig7_runs():
    got = fig7_speedup.run(**FIG7, seq_playouts=32, metrics=True,
                           device="cpu")
    want = jfig7.run(**FIG7)
    return got, want


def test_fig7_points_equal_reference(fig7_runs):
    got, want = fig7_runs
    assert got["device"] == "cpu"
    assert got["curves"].keys() == want["curves"].keys()
    for sched, pts in want["curves"].items():
        assert got["curves"][sched].keys() == pts.keys()
        for n_tasks, p in pts.items():
            g = got["curves"][sched][n_tasks]
            assert {k for k in p} <= set(g)
            assert g["tree_nodes"] == p["tree_nodes"], (sched, n_tasks)
            assert g["masked_lane_fraction"] == p["masked_lane_fraction"]
            assert g["speedup"] > 0 and g["playouts_per_s"] > 0


def test_fig7_best_moves_and_counters_equal_reference(fig7_runs):
    """Each point's search is the JAX package's search: its best move, and
    (with ``metrics``) its counters."""
    got, _ = fig7_runs
    board = jnp.zeros(25, jnp.int8)
    for sched, pts in got["curves"].items():
        for n_tasks, p in pts.items():
            cfg = jg.GSCPMConfig(board_size=5, n_playouts=256,
                                 n_tasks=int(n_tasks), n_workers=8,
                                 tree_cap=max(1 << 14, 4 * 256),
                                 scheduler=sched, metrics=True)
            _, st = jg.gscpm_search(board, 1, cfg, jax.random.key(0))
            assert p["best_move"] == st["best_move"], (sched, n_tasks)
            for k in fig7_speedup.METRIC_KEYS:
                assert p[k] == st["metrics"][k], (sched, n_tasks, k)


def test_ablate_vloss_equals_reference():
    kw = dict(n_playouts=256, n_workers=8, board_size=5, rounds=(1, 2, 4))
    got = ablate_vloss.run(**kw, device="cpu")
    want = jablate.run(**kw)
    assert got["rounds"] == want["rounds"]
    for r, w in want["results"].items():
        g = got["results"][r]
        for k in ("tree_nodes", "root_children", "best_move"):
            assert g[k] == w[k], (r, k)
        assert g["root_value"] == pytest.approx(w["root_value"], abs=1e-6)


def test_table2_fig9_and_root_parallel_run_on_the_cpu():
    t2 = table2_sequential.run(n_playouts=16, board_size=5, device="cpu")
    assert t2["device"] == "cpu" and t2["n_playouts"] == 16
    assert t2["extrapolated_paper_budget_s"] == pytest.approx(
        t2["per_playout_us"] * 1e-6 * tpaper.PAPER.n_playouts)
    measured = {"sequential_playouts_per_s": 1.0, "curves": {"fifo": {
        "4": {"speedup": 1.0}, "16": {"speedup": 2.0},
        "64": {"speedup": 2.5}}}}
    f9 = fig9_mapping.run(n_playouts=64, n_workers=4, board_size=5,
                          measured=measured, device="cpu")
    assert f9["dispatch_profile"]["n_spans"] == 1 + 4 + 16
    assert set(f9["overlay"]) == {"4", "16", "64"}
    assert set(f9["measured_vs_analytic"]) == {"61", "244"}
    rp = root_parallel.run(n_playouts=16, n_tasks=4, ensemble_sweep=(1, 2),
                           repeats=1, device="cpu")
    assert rp["device"] == "cpu" and set(rp["ensemble"]) == {"1", "2"}
    assert "multi-card" in rp["sharded_forest"]["skipped"]


@pytest.mark.parametrize("job,item", [
    ("tpfifo", "A11b"), ("serve_games", "A11b"), ("serve_chaos", "A11b"),
    ("selfplay", "A11b"), ("kernels_micro", "A11b"),
    ("roofline_table", "A13")])
def test_run_refuses_the_jobs_of_other_items(job, item):
    with pytest.raises(NotImplementedError, match=item):
        run.main(["--only", f"fig5,{job}", "--device", "cpu"])


def test_run_quick_writes_each_job(tmp_path, monkeypatch, capsys):
    """The aggregator's small form runs the chosen jobs and saves one JSON
    each (into a temporary directory here)."""
    from benchmarks_torch import common
    monkeypatch.setattr(common, "ART_DIR", str(tmp_path))
    results = run.main(["--quick", "--only", "fig5,table2", "--device", "cpu"])
    assert set(results) == {"fig5_cilkview", "table2_sequential"}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "fig5_cilkview.json", "table2_sequential.json"]
    assert "2/2 ok" in capsys.readouterr().out
