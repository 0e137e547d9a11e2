"""Whole gscpm_search: the port's tree == the JAX package's tree, field by
field, for 5x5 and 7x7 Hex, W in {1, 8}, three seeds and every scheduler.

Where the two ever differ, ``torch_parity_util.assert_same_search`` finds
the first differing child pick and requires its top-two score gap to be
under 1e-6; the comparison itself is never loosened.
"""

import numpy as np
import pytest
import torch

from repro_torch import parity, rng
from repro_torch.core import gscpm as tg
from repro_torch.core import tree as tt
from torch_parity_util import (assert_same_search, both_configs,
                               explain_divergence)

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

# hashed fields fixed per (size, W): the JAX side compiles four programs
CASES = [(size, W, sched)
         for size in (5, 7)
         for W, scheds in ((1, ("fifo", "rebalance", "one_per_core",
                                "sequential")),
                           (8, ("fifo", "rebalance", "one_per_core")))
         for sched in scheds]


def config_kw(size, W, sched):
    return dict(board_size=size, n_workers=W, tree_cap=1024, scheduler=sched,
                n_playouts=64 if W == 1 else 256,
                n_tasks=4 if W == 1 else 20)   # 20 tasks on 8 lanes: masked tail


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size,W,sched", CASES)
def test_search_tree_equals_reference(size, W, sched, seed):
    board = np.zeros(size * size, np.int8)
    tree, stats = assert_same_search(board, 1, config_kw(size, W, sched), seed)
    tt.check_invariants(tree)
    assert float(tree.visits[0]) == stats["playouts"]


@pytest.mark.parametrize("seed", [3, 4])
def test_search_from_midgame_position_equals_reference(seed):
    r = np.random.default_rng(seed)
    board = np.zeros(49, np.int8)
    cells = r.choice(49, 12, replace=False)
    board[cells[:6]], board[cells[6:]] = 1, 2
    kw = {**config_kw(7, 8, "fifo"), "cp": 0.7, "vl_rounds": 2}
    tree, _ = assert_same_search(board, 2, kw, seed)
    tt.check_invariants(tree)


def test_divergence_explainer_steps_both_packages():
    """The side-by-side stepping used on a mismatch runs end to end: on two
    searches that do NOT differ it must say so."""
    kw = {**config_kw(5, 8, "fifo"), "n_playouts": 32, "n_tasks": 4}
    tcfg, jcfg = both_configs(**kw)
    with pytest.raises(AssertionError, match="found no difference"):
        explain_divergence(np.zeros(25, np.int8), 1, tcfg, jcfg, 0, ["visits"])


def test_search_stats_and_device_rule():
    cfg = tg.GSCPMConfig(**config_kw(5, 8, "fifo"))
    board = torch.zeros(25, dtype=torch.int8)
    tree, st = tg.gscpm_search(board, 1, cfg, rng.key(0, "cpu"), device="cpu")
    assert tree.device.type == "cpu"
    assert st["playouts"] == 240 and st["rounds"] == 3 and st["grain"] == 12
    assert 0 < st["masked_lane_fraction"] < 0.5
    assert st["tree_nodes"] == int(tree.n_nodes)
    again, _ = tg.gscpm_search(board, 1, cfg, rng.key(0, "cpu"), device="cpu",
                               plain_kernels=True)
    assert parity.differing_fields(tree, again) == []
