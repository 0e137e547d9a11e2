"""Re-rooting between moves: the port == repro.core.tree's re-root half.

``reroot_tree`` / ``reroot_forest`` are integer programs (pointer doubling,
a BFS renumbering sort, gathers), so the port's result equals the JAX
package's in every field, for Hex and Gomoku trees, scalar and per-member
moves, unexpanded moves and a larger capacity. The retention contract holds
(``check_reroot_retention``), a capacity shrink raises, and a warm search
from a forest or tree carried over from the JAX package with
``convert.forest_from_numpy`` / ``tree_from_numpy`` equals the JAX
package's warm search, and is bit-identical run twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gscpm as jg
from repro.core import root_parallel as jrp
from repro.core import tree as jt
from repro_torch import convert, parity, rng
from repro_torch.core import gscpm as tg
from repro_torch.core import root_parallel as trp
from repro_torch.core import tree as tt
from torch_parity_util import jax_tree_fields

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

CAP = 1024


def kw_for(game, size, **over):
    return {**dict(game=game, board_size=size, n_workers=8, n_tasks=16,
                   n_playouts=256, tree_cap=CAP), **over}


def differing(t, j) -> list[str]:
    got, want = convert.tree_to_numpy(t), jax_tree_fields(j)
    return [k for k in want if got[k].dtype != want[k].dtype
            or not np.array_equal(got[k], want[k])]


@pytest.fixture(scope="module")
def forests():
    """Forests grown by the JAX package (3 members; Hex 5x5, Gomoku 7x7),
    with their port copies."""
    out = {}
    for game, size in (("hex", 5), ("gomoku", 7)):
        jf, st = jrp.gscpm_search_batch(
            jnp.zeros(size * size, jnp.int8), 1,
            jg.GSCPMConfig(**kw_for(game, size)), jax.random.key(size),
            n_trees=3, shard="off")
        out[game] = (jf, convert.forest_from_numpy(jax_tree_fields(jf), "cpu"),
                     st)
    return out


def root_moves(tree):
    kids = tree.children[0][: int(tree.n_children[0])]
    return tree.move[kids].tolist()


@pytest.mark.parametrize("game", ["hex", "gomoku"])
def test_reroot_tree_equals_reference(game, forests):
    jf, tf, st = forests[game]
    for e in range(3):
        src = tt.forest_member(tf, e)
        jsrc = jt.forest_member(jf, e)
        before = parity.clone_tree(src)
        n_cells = src.max_children
        missing = next(m for m in range(n_cells) if m not in root_moves(src))\
            if int(src.n_children[0]) < n_cells else None
        for mv in [st["member_best_moves"][e], root_moves(src)[-1], missing]:
            if mv is None:
                continue
            for new_cap in (None, 2 * CAP):
                dst = tt.reroot_tree(src, mv, new_cap=new_cap)
                assert differing(dst, jt.reroot_tree(jsrc, mv, new_cap)) == []
                n_sub = tt.check_reroot_retention(src, dst, mv)
                assert n_sub == (0 if mv == missing else int(dst.n_nodes))
                tt.check_invariants(dst)
                np.testing.assert_array_equal(tt.node_depths(dst),
                                              jt.node_depths(jt.reroot_tree(
                                                  jsrc, mv, new_cap)))
        # the source is left as it was
        assert parity.differing_fields(src, before) == []


@pytest.mark.parametrize("game", ["hex", "gomoku"])
def test_reroot_forest_equals_reference(game, forests):
    jf, tf, st = forests[game]
    best = st["best_move_sum"]
    per_member = np.array(st["member_best_moves"], np.int32)
    for moves in (best, per_member):
        dst = tt.reroot_forest(tf, torch.as_tensor(moves))
        assert differing(dst, jt.reroot_forest(jf, jnp.asarray(moves))) == []
        for e in range(3):
            mv = int(np.broadcast_to(moves, (3,))[e])
            tt.check_reroot_retention(tt.forest_member(tf, e),
                                      tt.forest_member(dst, e), mv)
        trp.check_forest_invariants(dst)
    assert differing(tt.reroot_forest(tf, best, new_cap=CAP + 7),
                     jt.reroot_forest(jf, best, new_cap=CAP + 7)) == []


def test_unexpanded_move_gives_a_fresh_one_node_tree():
    cfg = tg.GSCPMConfig(**kw_for("hex", 5, n_playouts=8, n_tasks=2,
                                  n_workers=2))
    tree, _ = tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1, cfg,
                              rng.key(0, "cpu"), device="cpu")
    missing = next(m for m in range(25) if m not in root_moves(tree))
    dst = tt.reroot_tree(tree, missing)
    assert tt.check_reroot_retention(tree, dst, missing) == 0
    fresh = tt.init_tree(CAP, 25, 2, device="cpu")
    assert parity.differing_fields(dst, fresh) == []


def test_capacity_shrink_raises():
    cfg = tg.GSCPMConfig(**kw_for("hex", 5, n_playouts=16, n_tasks=2))
    tree, st = tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1, cfg,
                               rng.key(0, "cpu"), device="cpu")
    with pytest.raises(ValueError, match="capacity overflow"):
        tt.reroot_tree(tree, st["best_move"], new_cap=CAP // 2)
    forest = tt.init_forest(2, CAP, 25, 1, "cpu")
    with pytest.raises(ValueError, match="capacity overflow"):
        tt.reroot_forest(forest, 0, new_cap=CAP - 1)


def test_root_summaries_equal_reference(forests):
    jf, tf, _ = forests["hex"]
    src, jsrc = tt.forest_member(tf, 0), jt.forest_member(jf, 0)
    got = tt.root_summary(src, 25, reused_visits=7)
    want = jt.root_summary(jsrc, 25, reused_visits=7)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    dev = tt.root_summary_device(src, 25)
    assert all(isinstance(v, torch.Tensor) for v in dev.values())
    late = tt.materialize_root_summary(dev)
    for k in late:
        np.testing.assert_array_equal(np.asarray(late[k]), np.asarray(got[k]))


@pytest.mark.parametrize("game", ["hex", "gomoku"])
def test_warm_forest_search_equals_reference(game, forests):
    """Move 2 of forest self-play from the JAX package's re-rooted forest,
    carried over with forest_from_numpy: the port's warm search equals the
    JAX package's, and the same warm search run twice is bit-identical."""
    jf, _, st = forests[game]
    size = 5 if game == "hex" else 7
    mv = st["best_move_sum"]
    jwarm = jt.reroot_forest(jf, mv)
    warm_fields = jax_tree_fields(jwarm)   # the JAX search donates jwarm
    kw = kw_for(game, size, n_playouts=128)
    jboard = jg.GSCPMConfig(**kw).game_obj.place(
        jnp.zeros(size * size, jnp.int8), jnp.int32(mv), jnp.int8(1))
    jout, jst = jrp.gscpm_search_batch(jboard, 2, jg.GSCPMConfig(**kw),
                                       jax.random.key(21), forest=jwarm,
                                       shard="off")
    board = torch.from_numpy(np.array(jboard))
    outs = []
    for _ in range(2):
        warm = convert.forest_from_numpy(warm_fields, "cpu")
        tout, tst = trp.gscpm_search_batch(board, 2, tg.GSCPMConfig(**kw),
                                           rng.key(21, "cpu"), forest=warm,
                                           device="cpu")
        outs.append(tout)
        assert differing(tout, jout) == []
        assert tst["reused_nodes"] == jst["reused_nodes"] > 0
    assert parity.differing_fields(*outs) == []


def test_warm_tree_search_equals_reference(forests):
    jf, _, st = forests["gomoku"]
    mv = st["member_best_moves"][1]
    jwarm = jt.reroot_tree(jt.forest_member(jf, 1), mv)
    warm = convert.tree_from_numpy(jax_tree_fields(jwarm), "cpu")
    kw = kw_for("gomoku", 7, n_playouts=128)
    jboard = jnp.zeros(49, jnp.int8).at[mv].set(1)
    jout, jst = jg.gscpm_search(jboard, 2, jg.GSCPMConfig(**kw),
                                jax.random.key(4), tree=jwarm)
    tout, tst = tg.gscpm_search(torch.from_numpy(np.array(jboard)), 2,
                                tg.GSCPMConfig(**kw), rng.key(4, "cpu"),
                                tree=warm, device="cpu")
    assert differing(tout, jout) == []
    assert tst["reused_nodes"] == jst["reused_nodes"]
    assert tst["reused_visits"] == jst["reused_visits"]


def test_forest_from_numpy_refuses_a_single_tree():
    one = convert.tree_to_numpy(tt.init_tree(16, 9, 1, device="cpu"))
    with pytest.raises(ValueError, match="member axis"):
        convert.forest_from_numpy(one, "cpu")
    two = convert.tree_to_numpy(tt.init_forest(2, 16, 9, 1, "cpu"))
    assert tt.forest_size(convert.forest_from_numpy(two, "cpu")) == 2
