"""The work counts: the same whichever implementation of a stage ran, and
never above what the kernels' exact probes count."""

import dataclasses

import numpy as np
import pytest

from bench_util import tiny_root
from mctsbench import harness
from mctsbench.manifest import Manifest
from mctsbench.program import Program


def counted(tmp_path, game, descent, playout):
    root = tiny_root(tmp_path, game)
    man = Manifest(root)
    config = man.config("tiny")
    params = man.workload_params("tiny.moves")
    traffic = man.module("traffic", "closed_batch").Traffic(params, config,
                                                            99)
    prog = Program(config, params, "cpu")
    prog.cfg = dataclasses.replace(prog.cfg, descent=descent, playout=playout)
    traffic.setup(prog)
    with harness.probing(man, params["probes"]) as probes:
        step = traffic.step(prog, 0, [], metrics=True)
    c = traffic.counts(step, 0)
    return c, harness.stage_work(man, params, c), probes


@pytest.mark.parametrize("game", ["hex", "gomoku"])
def test_stage_counts_do_not_depend_on_the_implementation(tmp_path, game):
    c1, w1, _ = counted(tmp_path / "a", game, "batched", "batched")
    c2, w2, _ = counted(tmp_path / "b", game, "scalar", "scalar")
    assert c1 == c2
    assert w1 == w2
    assert c1["iterations"] == 32 and c1["lane_iterations"] == 4 * 256
    assert set(w1) == {"descent", "propose", "expand", "playout", "backup"}
    assert all(b > 0 and o > 0 for b, o in w1.values())


@pytest.mark.parametrize("game", ["hex", "gomoku"])
def test_stage_bounds_stay_under_the_exact_counts(tmp_path, game):
    _, stages, probes = counted(tmp_path, game, "batched", "batched")
    d = probes["select_descent"]
    assert d["calls"] == 32
    assert 0 < stages["descent"][1] <= d["ops"]
    if game == "hex":
        p = probes["hex_playout"]
        assert p["calls"] == 32
        assert 0 < stages["playout"][1] <= p["ops"]
        assert stages["playout"][1] > 0.99 * p["ops"]
    else:
        assert probes["hex_playout"]["calls"] == 0


def test_least_time_and_rounds():
    from mctsbench import work
    pk = {"hbm_bytes_per_s": 2.0, "ops_per_s": 4.0}
    assert work.least_s(10, 4, pk) == 5.0
    assert work.least_s(2, 40, pk) == 10.0
    assert work.doubling_rounds(121) == 9
    assert work.row_bytes(121) == 512 and work.row_bytes(225) == 928
    assert np.isclose(work.peaks()["ops_per_s"], 67e12)
