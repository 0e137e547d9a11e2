"""Root-parallel forest search: the port == repro.core.root_parallel.

``gscpm_search_batch`` on Hex and Gomoku, E in {1, 3}, merge_every in {0, 2},
one position tiled to E or E different positions, gives forests equal to the
JAX package's field by field. Member e equals a single-tree search keyed
``fold_in(key, e)``. The merges, the delta-tracked sync, the inert padding
and the one-device ``shard`` rule hold as in the reference. The forest-legal
tree ops (step one of the slice) equal E single-tree ops, and the forest
descent's plain version equals a numpy mirror of the kernel's member-offset
walk and ``jax.vmap`` of the JAX ``select_batch``.
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
from repro_torch.kernels import ops as tops
from test_torch_fused_hex import np_fold_in, np_uct_score, np_uniform
from torch_parity_util import jax_keys, jax_tree_fields, tree_to_jax

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)


def differing(tforest, jforest) -> list[str]:
    got, want = convert.tree_to_numpy(tforest), jax_tree_fields(jforest)
    return [k for k in want if got[k].dtype != want[k].dtype
            or not np.array_equal(got[k], want[k])]


def kw_for(game, size):
    return dict(game=game, board_size=size, n_workers=8, n_tasks=20,
                n_playouts=160, tree_cap=1024)


def positions(size, E, seed):
    """E different mid-game positions (no five, no full board) and movers."""
    r = np.random.default_rng(seed)
    n = size * size
    boards = np.zeros((E, n), np.int8)
    for e in range(E):
        cells = r.choice(n, 2 * e, replace=False)
        boards[e, cells[:e]], boards[e, cells[e:]] = 1, 2
    return boards, (1 + np.arange(E) % 2).astype(np.int32)


def both_batches(board, to_move, kw, seed, **opts):
    tforest, tst = trp.gscpm_search_batch(
        torch.from_numpy(board), torch.as_tensor(to_move), tg.GSCPMConfig(**kw),
        rng.key(seed, "cpu"), device="cpu", **opts)
    jforest, jst = jrp.gscpm_search_batch(
        jnp.asarray(board), jnp.asarray(to_move), jg.GSCPMConfig(**kw),
        jax.random.key(seed), shard="off", **opts)
    return tforest, tst, jforest, jst


CASES = [("hex", 5, 1, 0), ("hex", 5, 3, 0), ("hex", 5, 3, 2),
         ("hex", 7, 3, 0), ("gomoku", 7, 1, 0), ("gomoku", 7, 3, 0),
         ("gomoku", 7, 3, 2)]


@pytest.mark.parametrize("game,size,E,merge_every", CASES)
def test_forest_search_equals_reference_tiled(game, size, E, merge_every):
    board = np.zeros(size * size, np.int8)
    tf, tst, jf, jst = both_batches(board, 1, kw_for(game, size), E,
                                    n_trees=E, merge_every=merge_every)
    assert differing(tf, jf) == []
    for k in ("playouts", "playouts_per_tree", "rounds", "grain", "n_syncs",
              "tree_nodes", "member_best_moves", "best_move_sum",
              "best_move_vote", "n_trees"):
        assert tst[k] == jst[k], k
    np.testing.assert_array_equal(np.float32(tst["member_root_values"]),
                                  np.float32(jst["member_root_values"]))
    trp.check_forest_invariants(tf)
    if merge_every:
        # after the final sync every member's root holds the whole ensemble
        assert (tf.visits[:, 0] == tst["playouts"]).all()
    else:
        assert (tf.visits[:, 0] == tst["playouts_per_tree"]).all()


@pytest.mark.parametrize("game,merge_every", [("hex", 0), ("hex", 2),
                                              ("gomoku", 0)])
def test_forest_search_equals_reference_per_position(game, merge_every):
    size = 5 if game == "hex" else 7
    boards, to_move = positions(size, 3, seed=11)
    tf, tst, jf, jst = both_batches(boards, to_move, kw_for(game, size), 4,
                                    merge_every=merge_every)
    assert differing(tf, jf) == []
    assert tst["member_best_moves"] == jst["member_best_moves"]
    assert tf.to_move[:, 0].tolist() == to_move.tolist()


@pytest.mark.parametrize("game,size", [("hex", 5), ("gomoku", 7)])
def test_member_equals_single_tree_search_with_member_key(game, size):
    cfg = tg.GSCPMConfig(**kw_for(game, size))
    board = torch.zeros(size * size, dtype=torch.int8)
    key = rng.key(9, "cpu")
    forest, _ = trp.gscpm_search_batch(board, 1, cfg, key, n_trees=3,
                                       device="cpu")
    for e in range(3):
        tree, _ = tg.gscpm_search(board, 1, cfg, rng.fold_in(key, e),
                                  device="cpu")
        assert parity.differing_fields(tt.forest_member(forest, e), tree) == []


@pytest.mark.parametrize("game,size", [("hex", 5), ("gomoku", 6)])
def test_scalar_oracles_equal_the_batched_forest(game, size):
    """The per-lane oracles (``descent="scalar"``, ``playout="scalar"``)
    walk the members one by one; the batched forest pass equals them."""
    kw = {**kw_for(game, size), "n_playouts": 48, "n_tasks": 8,
          "vl_rounds": 2}
    boards, to_move = positions(size, 2, seed=3)
    runs = [trp.gscpm_search_batch(torch.from_numpy(boards),
                                   torch.from_numpy(to_move),
                                   tg.GSCPMConfig(**kw, **over),
                                   rng.key(6, "cpu"), device="cpu")[0]
            for over in ({}, dict(descent="scalar"), dict(playout="scalar"))]
    assert parity.differing_fields(runs[0], runs[1]) == []
    assert parity.differing_fields(runs[0], runs[2]) == []


@pytest.fixture(scope="module")
def jax_forest():
    """A 4-member Hex 5x5 forest grown by the JAX package, and its port."""
    kw = kw_for("hex", 5)
    jf, _ = jrp.gscpm_search_batch(jnp.zeros(25, jnp.int8), 1,
                                   jg.GSCPMConfig(**kw), jax.random.key(5),
                                   n_trees=4, shard="off")
    fields = jax_tree_fields(jf)
    return jf, fields


def test_merges_equal_reference(jax_forest):
    jf, fields = jax_forest
    tf = convert.forest_from_numpy(fields, "cpu")
    tv, tw = trp.merged_root_stats(tf, 25)
    jv, jw = jrp.merged_root_stats(jf, 25)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int(trp.ensemble_best_move(tf, 25)) == int(jrp.ensemble_best_move(jf, 25))
    assert int(trp.majority_vote_move(tf, 25)) == int(jrp.majority_vote_move(jf, 25))
    ts, js = trp.forest_summary(tf, 25), jrp.forest_summary(jf, 25)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    tsum = trp.forest_root_summary(tf, 25)
    jsum = jrp.forest_root_summary(jf, 25)
    assert tsum.keys() == jsum.keys()
    for k in jsum:
        np.testing.assert_array_equal(np.asarray(tsum[k]), np.asarray(jsum[k]))
    # n_real slices pad members off first; a fresh forest reports -1
    part_t = trp.forest_root_summary(tf, 25, n_real=2)
    part_j = jrp.forest_root_summary(jf, 25, n_real=2)
    np.testing.assert_array_equal(part_t["root_visits"], part_j["root_visits"])
    fresh = trp.forest_root_summary(tt.init_forest(2, 16, 25, 1, "cpu"), 25)
    assert fresh["best_move"] == -1 and fresh["tree_nodes"] == 2


def test_sync_root_stats_equals_reference_and_never_double_counts(jax_forest):
    jf, fields = jax_forest
    tf = convert.forest_from_numpy(fields, "cpu")
    E = tf.parent.shape[0]
    ts, js = trp.init_sync_state(E, 25, "cpu"), jrp.init_sync_state(E, 25)
    own = tf.visits[:, 0].clone()
    for _ in range(3):     # repeated syncs with no new work change nothing
        tf, ts = trp.sync_root_stats(tf, ts, 25)
        jf, js = jrp.sync_root_stats(jf, js, 25)
        assert differing(tf, jf) == []
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (tf.visits[:, 0] == own.sum()).all()
    trp.check_forest_invariants(tf)


def test_pad_members_are_inert():
    kw = kw_for("hex", 5)
    cfg = tg.GSCPMConfig(**kw)
    boards = torch.zeros((3, 25), dtype=torch.int8)
    key = rng.key(2, "cpu")
    real, _ = trp.gscpm_search_batch(boards, 1, cfg, key, device="cpu")
    forest = tt.init_forest(3, cfg.tree_cap, 25, 1, "cpu")
    forest, padded = trp.pad_forest_members(forest, boards, 5, cfg, 1)
    assert padded.shape == (5, 25) and tt.forest_size(forest) == 5
    member_keys = tg.fold_task_keys(key, torch.arange(3, dtype=torch.int32))
    member_keys = torch.cat([member_keys, rng.split(key, 2)])
    for rnd in tg.sched.make_schedule(cfg.n_playouts, cfg.n_tasks,
                                      cfg.n_workers, cfg.scheduler):
        forest = trp.run_schedule_round_forest(forest, padded, cfg,
                                               member_keys, rnd, cfg.cp,
                                               n_real=3)
    assert parity.differing_fields(tt.Tree(*(x[:3] for x in forest)), real) == []
    fresh = tt.init_forest(2, cfg.tree_cap, 25, 1, "cpu")
    assert parity.differing_fields(tt.Tree(*(x[3:] for x in forest)), fresh) == []
    same, same_b = trp.pad_forest_members(real, boards, 3, cfg, 1)
    assert same is real and same_b is boards


def test_one_device_shard_rules_and_argument_checks():
    cfg = tg.GSCPMConfig(**kw_for("hex", 5))
    board = torch.zeros(25, dtype=torch.int8)
    key = rng.key(0, "cpu")
    with pytest.raises(RuntimeError, match="require"):
        trp.gscpm_search_batch(board, 1, cfg, key, n_trees=2, shard="require",
                               device="cpu")
    with pytest.raises(ValueError, match="shard"):
        trp.gscpm_search_batch(board, 1, cfg, key, n_trees=2, shard="on",
                               device="cpu")
    with pytest.raises(ValueError, match="n_trees"):
        trp.gscpm_search_batch(torch.zeros((3, 25), dtype=torch.int8), 1, cfg,
                               key, n_trees=2, device="cpu")
    with pytest.raises(ValueError, match="members"):
        trp.gscpm_search_batch(torch.zeros((3, 25), dtype=torch.int8), 1, cfg,
                               key, forest=tt.init_forest(2, 1024, 25, 1, "cpu"),
                               device="cpu")
    _, st = trp.gscpm_search_batch(board, 1, cfg, key, n_trees=2, shard="off",
                                   device="cpu")
    assert (st["sharded"], st["n_devices"], st["padded_members"]) == (False, 1, 0)
    if torch.cuda.device_count() <= 1:
        assert trp.ensemble_mesh() is None
        assert trp.ensemble_sharding(3) == (None, 3)
    with pytest.raises(NotImplementedError, match="A7"):
        trp.ensemble_spec(None)
    with pytest.raises(NotImplementedError, match="A7"):
        trp._sharded_chunk()


def test_init_forest_and_members_match_reference():
    tf = tt.init_forest(3, 32, 9, torch.tensor([1, 2, 1]), "cpu")
    jf = jt.init_forest(3, 32, 9, jnp.asarray([1, 2, 1]))
    assert differing(tf, jf) == []
    assert differing(tt.init_forest(2, 32, 9, 2, "cpu"),
                     jt.init_forest(2, 32, 9, 2)) == []
    assert tt.forest_size(tf) == 3 and tf.cap == 32
    m = tt.forest_member(tf, 1)
    m.visits[0] = 5.0          # a member is a view of its forest
    assert float(tf.visits[1, 0]) == 5.0


# ---------------------------------------- forest-legal tree operations ----
def random_forest(E, seed):
    """E members of a real Hex 5x5 forest search (different trees)."""
    cfg = tg.GSCPMConfig(**kw_for("hex", 5))
    forest, _ = trp.gscpm_search_batch(torch.zeros(25, dtype=torch.int8), 1,
                                       cfg, rng.key(seed, "cpu"), n_trees=E,
                                       device="cpu")
    return forest


def member_paths(forest, W, seed):
    """(E, W, D) member-local paths: random root-to-node walks, PAD-filled,
    and (E, W) values / weights with draws and masked lanes."""
    r = np.random.default_rng(seed)
    E, cap = forest.parent.shape[0], forest.cap
    D = 6
    paths = np.full((E, W, D), cap, np.int32)
    for e in range(E):
        n = int(forest.n_nodes[e])
        par = forest.parent[e].numpy()
        for w in range(W):
            node = int(r.integers(0, n))
            walk = [node]
            while walk[-1] != 0:
                walk.append(int(par[walk[-1]]))
            walk = walk[::-1][:D]
            paths[e, w, :len(walk)] = walk
    values = r.integers(0, 3, (E, W)).astype(np.int8)
    weights = (r.random((E, W)) < 0.8).astype(np.float32)
    return (torch.from_numpy(paths), torch.from_numpy(values),
            torch.from_numpy(weights))


def test_forest_tree_ops_equal_member_by_member_ops():
    forest = random_forest(3, seed=1)
    paths, values, weights = member_paths(forest, 8, seed=2)
    got = parity.clone_tree(forest)
    tt.backup_paths(got, paths, values, weights)
    tt.add_vloss(got, paths, weights, 2.0)
    nodes = paths[:, :, 2].clone()
    nodes[nodes == forest.cap] = 0
    tile = tt.child_stat_tile(got, nodes)
    for e in range(3):
        one = parity.clone_tree(tt.forest_member(forest, e))
        tt.backup_paths(one, paths[e], values[e], weights[e])
        tt.add_vloss(one, paths[e], weights[e], 2.0)
        assert parity.differing_fields(tt.forest_member(got, e), one) == []
        for a, b in zip(tile, tt.child_stat_tile(one, nodes[e])):
            assert torch.equal(a[e], b)
    # every member's PAD row stays zero, and vloss resets everywhere
    assert (got.visits[:, got.cap] == 0).all() and (got.vloss[:, got.cap] == 0).all()
    assert (tt.reset_vloss(got).vloss == 0).all()
    # against jax.vmap of the reference's ops
    jf = tree_to_jax(forest)
    jp, jv, jw = (jnp.asarray(x.numpy()) for x in (paths, values, weights))
    jf = jax.vmap(jt.backup_paths)(jf, jp, jv, jw)
    jf = jax.vmap(lambda t, p, w: jt.add_vloss(t, p, w, 2.0))(jf, jp, jw)
    want = parity.clone_tree(forest)
    tt.backup_paths(want, paths, values, weights)
    tt.add_vloss(want, paths, weights, 2.0)
    assert differing(want, jf) == []


def test_forest_expand_batch_equals_vmapped_reference():
    forest = random_forest(3, seed=4)
    r = np.random.default_rng(5)
    E, W = 3, 12
    leaves = np.stack([r.integers(0, int(forest.n_nodes[e]), W) for e in range(E)])
    leaves[:, :4] = leaves[:, :1]          # collisions on one leaf
    moves = r.integers(-1, 25, (E, W)).astype(np.int32)
    moves[:, 1] = moves[:, 0]              # a duplicate proposal
    active = r.random((E, W)) < 0.9
    tleaves, tmoves = (torch.from_numpy(x.astype(np.int32)) for x in (leaves, moves))
    got, ids = tg.expand_batch(parity.clone_tree(forest), tleaves, tmoves,
                               torch.from_numpy(active))
    jf, jids = jax.vmap(jg.expand_batch)(
        tree_to_jax(forest), jnp.asarray(leaves.astype(np.int32)),
        jnp.asarray(moves), jnp.asarray(active))
    assert differing(got, jf) == []
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    # near capacity: members allocate from their own counters
    full = parity.clone_tree(forest)
    full.n_nodes.copy_(torch.tensor([full.cap - 1, full.cap - 2, full.cap]))
    got, ids = tg.expand_batch(full, tleaves, tmoves, torch.from_numpy(active))
    jf, jids = jax.vmap(jg.expand_batch)(
        tree_to_jax(parity.clone_tree(full)._replace(
            n_nodes=torch.tensor([full.cap - 1, full.cap - 2, full.cap],
                                 dtype=torch.int32))),
        jnp.asarray(leaves.astype(np.int32)), jnp.asarray(moves),
        jnp.asarray(active))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


# ------------------------------ the forest descent, member by member ----
def forest_descent_mirror(forest, root_boards, keys, cp, scale, max_depth):
    """select_descent_kernel over a forest, lane by lane, on the FLAT
    E·(cap + 1) rows: lane g walks member g // W, every read offset by that
    member's rows; member-local ids out."""
    f = convert.tree_to_numpy(forest)
    E, rows = f["parent"].shape
    cap, C = rows - 1, f["children"].shape[-1]
    flat = {k: v.reshape(E * rows, *v.shape[2:]) for k, v in f.items()
            if k != "n_nodes"}
    boards0 = root_boards.numpy()
    n = boards0.shape[1]
    W = keys.shape[1]
    kw = keys.numpy().reshape(E * W, 2).astype(np.uint32)
    paths = np.full((E * W, max_depth), cap, np.int32)
    paths[:, 0] = 0
    depths, leaves, n_empty = (np.zeros(E * W, np.int32) for _ in range(3))
    boards = np.zeros((E * W, n), np.int8)
    for g in range(E * W):
        off = (g // W) * rows
        board = boards0[g // W].copy()
        empties = int((board == 0).sum())
        node = depth = 0
        while (flat["n_children"][off + node] == empties and empties != 0
               and depth < max_depth - 2):
            log_np = np.log(max(np.float32(flat["visits"][off + node]
                                           + flat["vloss"][off + node]),
                                np.float32(1)))
            kids = flat["children"][off + node][:flat["n_children"][off + node]]
            noise = (np.float32(scale) * np_uniform(
                np_fold_in((kw[g, 0], kw[g, 1]), depth), np.arange(len(kids)))
                if scale > 0.0 else np.zeros(len(kids), np.float32))
            best, best_j = -np.inf, None
            for j, c in enumerate(kids):
                s = np_uct_score(flat["wins"][off + c], flat["visits"][off + c],
                                 flat["vloss"][off + c], log_np, cp, noise[j])
                if s > best:
                    best, best_j = s, j
            child = kids[best_j]
            board[flat["move"][off + child]] = flat["to_move"][off + node]
            depth += 1
            paths[g, depth] = child
            node, empties = child, empties - 1
        depths[g], leaves[g], n_empty[g], boards[g] = depth, node, empties, board
    out = (paths, depths, leaves, boards, n_empty)
    return tuple(x.reshape(E, W, *x.shape[1:]) for x in out)


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_forest_descent_equals_mirror_and_vmapped_reference(noise):
    forest = random_forest(3, seed=6)
    boards = np.zeros((3, 25), np.int8)   # the searched positions
    forest.vloss[1, : forest.cap].copy_(
        torch.randint(0, 2, (forest.cap,), generator=torch.Generator()
                      .manual_seed(0)).float())
    forest.n_children[2, 0] -= 1            # a held lane: root one short
    tb = torch.from_numpy(boards)
    keys = rng.split(rng.key(3, "cpu"), 24).view(3, 8, 2)
    got = tops.select_descent(forest, tb, tg.GSCPMConfig(board_size=5).game_obj,
                              1.0, keys, noise)
    mirror = forest_descent_mirror(forest, tb, keys, 1.0, noise, 26)
    for a, b in zip(got, mirror):
        np.testing.assert_array_equal(a.numpy(), b)
    jgame = jg.GSCPMConfig(board_size=5).game_obj
    want = jax.vmap(lambda t, b, k: jg.select_batch(t, b, jgame, jnp.float32(1.0),
                                                    k, noise))(
        tree_to_jax(forest), jnp.asarray(boards), jax_keys(keys))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[1][2] == 0).all() and (got[1][0] > 0).any()
