"""Port tree ops == repro.core.tree on the same numpy inputs: equality."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tree as jt
from repro_torch import convert
from repro_torch.core import tree as tt
from repro_torch.core.gscpm import GSCPMConfig

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

CAP, C = 40, 9


def random_tree_fields(seed: int, n_nodes: int = 25) -> dict:
    """A structurally valid random tree (parents before children, distinct
    child moves) with integer visit counts and half-integer wins."""
    rng = np.random.default_rng(seed)
    f = {
        "parent": np.full(CAP + 1, -1, np.int32),
        "move": np.full(CAP + 1, -1, np.int32),
        "to_move": np.zeros(CAP + 1, np.int32),
        "children": np.full((CAP + 1, C), -1, np.int32),
        "n_children": np.zeros(CAP + 1, np.int32),
        "visits": np.zeros(CAP + 1, np.float32),
        "wins": np.zeros(CAP + 1, np.float32),
        "vloss": np.zeros(CAP + 1, np.float32),
        "n_nodes": np.asarray(n_nodes, np.int32),
    }
    f["to_move"][0] = 1
    for i in range(1, n_nodes):
        while True:
            p = int(rng.integers(0, i))
            if f["n_children"][p] < C:
                break
        used = set(f["move"][f["children"][p][: f["n_children"][p]]].tolist())
        mv = int(rng.choice([m for m in range(C) if m not in used]))
        f["parent"][i], f["move"][i] = p, mv
        f["to_move"][i] = 3 - f["to_move"][p]
        f["children"][p, f["n_children"][p]] = i
        f["n_children"][p] += 1
    # leaf-up visit counts so children never exceed parents
    for i in range(n_nodes - 1, -1, -1):
        kids = f["children"][i][: f["n_children"][i]]
        f["visits"][i] = f["visits"][kids].sum() + rng.integers(1, 4)
        f["wins"][i] = rng.integers(0, 2 * int(f["visits"][i]) + 1) / 2
    return f


def both(fields):
    jtree = jt.Tree(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jtree, convert.tree_from_numpy(fields, "cpu")


def assert_trees_equal(ttree, jtree):
    got = convert.tree_to_numpy(ttree)
    for name in jt.Tree._fields:
        want = np.asarray(getattr(jtree, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_init_tree_matches():
    assert_trees_equal(tt.init_tree(CAP, C, 2, device="cpu"),
                       jt.init_tree(CAP, C, 2))
    t = tt.init_tree(CAP, C, 1, device="cpu")
    assert t.cap == CAP and t.max_children == C
    with pytest.raises((AssertionError, RuntimeError)):
        tt.init_tree(CAP, C, 1)     # device=None means the GPU; none here


def test_convert_round_trip():
    f = random_tree_fields(0)
    back = convert.tree_to_numpy(convert.tree_from_numpy(f, "cpu"))
    for k, v in f.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    with pytest.raises(KeyError):
        convert.tree_from_numpy({"parent": f["parent"]}, "cpu")
    cfg = GSCPMConfig(board_size=5, n_playouts=77, cp=0.5)
    assert convert.config_from_dict(dataclasses.asdict(cfg)) == cfg
    assert convert.config_from_dict(dataclasses.asdict(cfg)).n_playouts == 77
    with pytest.raises(KeyError):
        convert.config_from_dict({"no_such_knob": 1})


def random_paths(seed, W=6, D=7):
    rng = np.random.default_rng(100 + seed)
    paths = np.full((W, D), CAP, np.int32)
    for w in range(W):
        L = int(rng.integers(1, D + 1))
        paths[w, :L] = rng.integers(0, 25, L)
    values = rng.integers(0, 3, W).astype(np.int8)        # draws included
    weights = (rng.random(W) < 0.8).astype(np.float32)
    return paths, values, weights


@pytest.mark.parametrize("seed", range(4))
def test_backup_paths_matches(seed):
    jtree, ttree = both(random_tree_fields(seed))
    paths, values, weights = random_paths(seed)
    want = jt.backup_paths(jtree, jnp.asarray(paths), jnp.asarray(values),
                           jnp.asarray(weights))
    got = tt.backup_paths(ttree, torch.from_numpy(paths),
                          torch.from_numpy(values), torch.from_numpy(weights))
    assert got.visits is ttree.visits      # in place, as documented
    assert_trees_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_backup_is_order_independent(seed):
    """Credits are 0, 0.5, 1, so float32 sums are exact: any lane order
    gives the same bits (what makes CUDA's atomic adds reproducible)."""
    f = random_tree_fields(seed)
    paths, values, weights = random_paths(seed, W=16)
    perm = np.random.default_rng(seed).permutation(16)
    a = tt.backup_paths(convert.tree_from_numpy(f, "cpu"),
                        torch.from_numpy(paths), torch.from_numpy(values),
                        torch.from_numpy(weights))
    b = tt.backup_paths(convert.tree_from_numpy(f, "cpu"),
                        torch.from_numpy(paths[perm]),
                        torch.from_numpy(values[perm]),
                        torch.from_numpy(weights[perm]))
    assert torch.equal(a.visits, b.visits) and torch.equal(a.wins, b.wins)
    assert float(a.visits[CAP]) == 0.0 and float(a.wins[CAP]) == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_add_and_reset_vloss_match(seed):
    jtree, ttree = both(random_tree_fields(seed))
    paths, _, weights = random_paths(seed)
    want = jt.add_vloss(jtree, jnp.asarray(paths), jnp.asarray(weights), 1.5)
    got = tt.add_vloss(ttree, torch.from_numpy(paths),
                       torch.from_numpy(weights), 1.5)
    assert_trees_equal(got, want)
    assert_trees_equal(tt.reset_vloss(got), jt.reset_vloss(want))


@pytest.mark.parametrize("seed", range(4))
def test_child_stat_tile_matches(seed):
    f = random_tree_fields(seed)
    f["vloss"][:25] = np.random.default_rng(seed).integers(0, 3, 25)
    jtree, ttree = both(f)
    nodes = np.random.default_rng(seed).integers(0, 25, 8).astype(np.int32)
    want = jt.child_stat_tile(jtree, jnp.asarray(nodes))
    got = tt.child_stat_tile(ttree, torch.from_numpy(nodes))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(6))
def test_root_readouts_match(seed):
    f = random_tree_fields(seed)
    if seed % 2:        # force a tie on the root's visit counts
        kids = f["children"][0][: f["n_children"][0]]
        f["visits"][kids] = 3.0
    jtree, ttree = both(f)
    assert int(tt.best_child(ttree)) == int(jt.best_child(jtree))
    np.testing.assert_array_equal(tt.root_value(ttree).numpy(),
                                  np.asarray(jt.root_value(jtree)))
    for g, w in zip(tt.root_move_stats(ttree, C), jt.root_move_stats(jtree, C)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got, want = tt.root_summary(ttree, C, 5), jt.root_summary(jtree, C, 5)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_empty_root_best_child_is_no_node():
    t = tt.init_tree(CAP, C, 1, device="cpu")
    assert int(tt.best_child(t)) == tt.NO_NODE == int(
        jt.best_child(jt.init_tree(CAP, C, 1)))
    assert float(tt.root_value(t)) == 0.0


def test_check_invariants_accepts_valid_and_catches_faults():
    f = random_tree_fields(3)
    tt.check_invariants(convert.tree_from_numpy(f, "cpu"))
    jt.check_invariants(jt.Tree(**{k: jnp.asarray(v) for k, v in f.items()}))
    for fault in ("parent", "dup_move", "stale_slot", "visits", "wins"):
        g = {k: v.copy() for k, v in f.items()}
        node = int(np.argmax(g["n_children"] >= 2))
        kids = g["children"][node]
        if fault == "parent":
            g["parent"][kids[0]] = (node + 1) % 25
        elif fault == "dup_move":
            g["move"][kids[1]] = g["move"][kids[0]]
        elif fault == "stale_slot":
            g["children"][node, C - 1] = 1
        elif fault == "visits":
            g["visits"][node] = 0.0
        else:
            g["wins"][node] = g["visits"][node] + 1.0
        with pytest.raises(AssertionError):
            tt.check_invariants(convert.tree_from_numpy(g, "cpu"))
