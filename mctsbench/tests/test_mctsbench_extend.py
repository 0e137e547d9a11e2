"""Cells, a configuration, a traffic kind, a cost stage and metrics added as
new files and new manifest entries, with no file of the benchmark edited,
run end to end on the CPU with throwaway cells; and the program's settings
come from the files whole, or are refused."""

import hashlib
import io
import json

import numpy as np
import pytest
import torch

from bench_util import ROOT, add_file, tiny_root
from mctsbench import harness, trace
from mctsbench.program import Program

EMPTY_BOARD = '''"""Every member searches the empty board."""
from pathlib import Path

import numpy as np

from mctsbench.manifest import load_module

base = load_module(Path(__file__).with_name("closed_batch.py"),
                   "mctsbench_traffic_closed_batch")


class Traffic(base.Traffic):
    def __init__(self, params, config, seed):
        super().__init__(dict(params, opening_plies=[0, 0]), config, seed)
'''
WARM_MOVE = '''"""A cold move, each member's best move played, a warm search
of the re-rooted forest; the cold move's answers are checked."""
from pathlib import Path

import numpy as np

from mctsbench.manifest import load_module
from mctsbench.reference import threefry

base = load_module(Path(__file__).with_name("closed_batch.py"),
                   "mctsbench_traffic_closed_batch")


class Traffic(base.Traffic):
    def step(self, program, i, keep, metrics=False):
        forest, stats = self._call(program, i, metrics=metrics)
        kept = program.stash(forest, stats, keep)
        moves = np.asarray(stats["member_best_moves"])
        boards, to_move, key = self.call(i)
        after = boards.copy()
        after[np.arange(len(after)), moves] = to_move
        forest = program.reroot(forest, moves)
        self.reused = int(forest.n_nodes.sum())
        b, tm = program.upload(after, 3 - to_move)
        _, warm = program.search(b, tm, threefry.fold_in(key, 1),
                                 forest=forest)
        assert warm["reused_nodes"] == self.reused - self.members
        return base.Step(stats["playouts"] + warm["playouts"],
                         2 * self.iterations, kept, stats)

    def counts(self, step, i):
        return dict(super().counts(step, i), reused=self.reused)
'''
REROOT = '''def work(c):
    return 16.0 * c["reused"], float(c["reused"])
'''
RATE = '''def read(obs):
    return obs["iterations"] / obs["window_s"]
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "mctsbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def cell(m, name, workloads, metric=None):
    m["workloads"].append({"name": name, "config": "tiny",
                           "traffic": name.split(".")[1], "chips": 1,
                           "why": "test"})
    if metric:
        m["end_to_end"].append({"name": metric, "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": [name]})
    for per in m["per_layer"]:
        per["workloads"].append(name)


def stub_profile(fn):
    fn()
    return trace.summarize([("some_kernel", 0.0, 10.0)], [])


def test_added_files_make_new_cells(tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    before = digests(root)
    add_file(root, "traffic/empty_board.py", EMPTY_BOARD)
    add_file(root, "traffic/warm_move.py", WARM_MOVE)
    add_file(root, "costs/reroot.py", REROOT)
    add_file(root, "metrics/iterations_per_s.py", RATE)
    tiny = json.loads((root / "mctsbench/workloads/tiny.moves.json")
                      .read_text())
    add_file(root, "workloads/tiny.empty.json",
             dict(tiny, traffic="empty", kind="empty_board"))
    add_file(root, "workloads/tiny.warm.json",
             dict(tiny, traffic="warm", kind="warm_move",
                  costs=[*tiny["costs"], "reroot"]))
    m = json.loads((root / "BENCHMARK.json").read_text())
    cell(m, "tiny.empty", m["workloads"], metric="iterations_per_s")
    cell(m, "tiny.warm", m["workloads"])
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())
    assert json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"] \
        == m["workloads"][:len(m["workloads"]) - 3]

    result = run(root, "tiny.empty", False)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"playouts_per_s", "setup_s",
                                      "iterations_per_s"}
    assert "iterations_per_s" not in run(root, "tiny.moves",
                                         False)["metrics"]

    # the traced run sums each cell's own cost stages, no others
    monkeypatch.setattr(trace, "profile", stub_profile)
    stages = []
    inner = harness.stage_work
    monkeypatch.setattr(harness, "stage_work", lambda man, params, c: stages
                        .append(inner(man, params, c)) or stages[-1])
    warm = run(root, "tiny.warm", True)
    moves = run(root, "tiny.moves", True)
    assert warm["correct"] is True and moves["correct"] is True
    assert set(stages[0]) == set(stages[1]) | {"reroot"}
    assert "reroot" not in stages[1]
    assert "search_mfu_pct" in warm["metrics"] and \
        "search_mfu_pct" in moves["metrics"]


def run(root, name, traced):
    return harness.run_cell(name, 5, 0.3, traced, root=root, device="cpu",
                            log=io.StringIO())


def tiny_config():
    return dict(game="hex", board_size=5, n_workers=8, cp=1.0,
                scheduler="fifo", vl_rounds=1, select_noise=1e-3,
                tree_cap=256, precision="float32", source="a test")


def test_the_program_takes_every_setting_or_refuses_it():
    search = {"n_playouts": 64, "n_tasks": 8}
    prog = Program(tiny_config(), {"search": search,
                                   "call": {"n_trees": 2}}, "cpu")
    assert (prog.cfg.tree_cap, prog.cfg.n_playouts) == (256, 64)
    boards = torch.zeros((2, 25), dtype=torch.int8)
    _, stats = prog.search(boards, torch.ones(2, dtype=torch.int32),
                           np.array([1, 2], np.uint32))
    assert stats["n_trees"] == 2 and stats["playouts"] == 2 * 64
    with pytest.raises(ValueError, match="vl_round"):
        Program(dict(tiny_config(), vl_round=2), {"search": search}, "cpu")
    with pytest.raises(ValueError, match="source"):
        Program(tiny_config(), {"search": dict(search, source="x")}, "cpu")
    bad = Program(tiny_config(), {"search": search,
                                  "call": {"merge_evry": 1}}, "cpu")
    with pytest.raises(TypeError, match="merge_evry"):
        bad.search(boards, torch.ones(2, dtype=torch.int32),
                   np.array([1, 2], np.uint32))
