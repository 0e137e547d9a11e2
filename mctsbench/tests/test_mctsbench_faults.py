"""A whole run on the CPU with the timed path broken underneath: each fault
the cells can have makes ``correct`` false, and a sound run is correct.
(The cells run on one card, so there is no exchange between cards to
leave out.)"""

import io

import pytest
import torch

from bench_util import tiny_root
from mctsbench.harness import run_cell


def run(root, seed=2**31 + 99):
    log = io.StringIO()
    result = run_cell("tiny.moves", seed, 0.5, False, root=root,
                      device="cpu", log=log)
    return result, log.getvalue()


def state_unchanged(monkeypatch):
    from repro_torch.core import gscpm

    def step(tree, root_board, cfg, cp, iter_keys, active, metrics=None):
        return tree if metrics is None else (tree, metrics)
    monkeypatch.setattr(gscpm, "sync_iteration", step)


def half_the_batch_left_out(monkeypatch):
    from repro_torch.core import root_parallel
    inner = root_parallel.run_chunk_forest

    def chunk(forest, boards, cfg, task_keys, active, m, cp, metrics=None):
        active = active.clone()
        active[active.shape[0] // 2:] = False
        return inner(forest, boards, cfg, task_keys, active, m, cp, metrics)
    monkeypatch.setattr(root_parallel, "run_chunk_forest", chunk)


def playout_value_altered(monkeypatch):
    from repro_torch.kernels import ops
    inner = ops.hex_playout
    monkeypatch.setattr(ops, "hex_playout",
                        lambda *a, **k: (3 - inner(*a, **k)).to(torch.int8))


def best_move_altered(monkeypatch):
    from repro_torch.core import root_parallel
    inner = root_parallel.forest_summary

    def summary(forest, n_moves):
        out = inner(forest, n_moves)
        out["member_best_moves"] = (out["member_best_moves"] + 1) % n_moves
        return out
    monkeypatch.setattr(root_parallel, "forest_summary", summary)


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch_left_out,
                                   playout_value_altered, best_move_altered])
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, fault):
    root = tiny_root(tmp_path)
    fault(monkeypatch)
    result, log = run(root)
    assert result["correct"] is False, log
    parted = result["checks"]["parted_members"]
    assert parted["value"] > parted["limit"]
    assert "parted:" in log


def test_sound_run_is_correct(tmp_path):
    result, log = run(tiny_root(tmp_path))
    assert result["correct"] is True, log
    assert result["failed"] == 0 and result["attempted"] % 4 == 0
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"parted_members": {"value": 0, "limit": 0}}
    assert result["metrics"]["playouts_per_s"]["value"] > 0


def test_kept_members_one_from_each_slice_of_the_batch():
    from mctsbench.harness import kept_members
    for seed in (1, 2**40 + 3):
        got = kept_members(seed, 7, 1024)
        assert [m // 128 for m in got] == list(range(8))
    assert kept_members(5, 0, 4) == [0, 1, 2, 3]
    assert kept_members(5, 0, 256) != kept_members(5, 1, 256)
