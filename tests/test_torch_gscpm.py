"""Port GSCPM pieces == repro.core.gscpm on the same inputs: expansion,
descent, one sync iteration from a carried-over mid-search tree, the port's
own scalar oracles, and the run-time knobs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gscpm as jg
from repro.core import scheduler as jsched
from repro.core import tree as jt
from repro_torch import convert, parity, rng
from repro_torch.core import gscpm as tg
from repro_torch.core import mcts as tmcts
from repro_torch.core import scheduler as tsched
from repro_torch.core import tree as tt
from repro_torch.kernels import _build
from torch_parity_util import (assert_trees_equal, both_configs, jax_keys,
                               jax_select, tree_to_jax)

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

SIZE = 5
KW = dict(board_size=SIZE, n_playouts=256, n_tasks=16, n_workers=8,
          tree_cap=1024)      # ONE config for the file: JAX jits once


def t32(x):
    return torch.tensor(x, dtype=torch.int32)


def j32(x):
    return jnp.asarray(x, dtype=jnp.int32)


def empty(size=SIZE):
    return np.zeros(size * size, np.int8)


# ------------------------------------------------------------ expansion ----
def expand_both(ttree, jtree, leaves, moves, active):
    ttree, tids = tg.expand_batch(ttree, t32(leaves), t32(moves),
                                  torch.tensor(active))
    jtree, jids = jg.expand_batch(jtree, j32(leaves), j32(moves),
                                  jnp.asarray(active))
    assert_trees_equal(ttree, jtree)
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    return ttree, jtree, tids.numpy()


def test_expand_batch_dedup_and_slots():
    ttree, jtree, ids = expand_both(
        tt.init_tree(64, 25, 1, device="cpu"), jt.init_tree(64, 25, 1),
        [0, 0, 0, 0], [3, 3, 7, -1], [True] * 4)  # dup (0,3); one invalid
    assert int(ttree.n_nodes) == 3  # root + 2 unique children
    assert ids[0] == ids[1] != 64  # duplicates collapse
    assert ids[3] == 64            # invalid proposal -> PAD
    assert int(ttree.n_children[0]) == 2
    kids = ttree.children[0][:2]
    assert sorted(ttree.move[kids].tolist()) == [3, 7]
    ttree.visits[0] = 1.0
    tt.check_invariants(ttree)


def test_expand_batch_multi_leaf():
    ttree, jtree, _ = expand_both(
        tt.init_tree(64, 25, 1, device="cpu"), jt.init_tree(64, 25, 1),
        [0, 0], [1, 2], [True, True])
    l1, l2 = int(ttree.children[0, 0]), int(ttree.children[0, 1])
    ttree, jtree, ids = expand_both(ttree, jtree, [l1, l2, l1, l2],
                                    [5, 5, 6, 9], [True] * 4)
    assert int(ttree.n_nodes) == 7
    assert int(ttree.n_children[l1]) == 2 and int(ttree.n_children[l2]) == 2
    assert len(set(ids.tolist())) == 4  # all distinct here


def test_expand_batch_capacity_clamp():
    ttree, _, ids = expand_both(       # room for root + 1 node only
        tt.init_tree(2, 25, 1, device="cpu"), jt.init_tree(2, 25, 1),
        [0, 0, 0], [1, 2, 3], [True] * 3)
    assert int(ttree.n_nodes) == 2
    assert (ids == 2).sum() == 2  # two proposals hit the PAD row (cap=2)


def test_expand_batch_inactive_lanes_and_unsorted_input():
    expand_both(tt.init_tree(64, 25, 1, device="cpu"), jt.init_tree(64, 25, 1),
                [0, 0, 0, 0, 0, 0], [9, 2, 9, 24, 2, 0],
                [True, False, True, True, True, False])


# ------------------------------------------- carried-over mid-search tree ----
@pytest.fixture(scope="module")
def midsearch():
    """A JAX search stopped after its first round: tree and key carried
    over to the port as numpy."""
    tcfg, jcfg = both_configs(**KW)
    key = jax.random.key(4)
    schedule = jsched.make_schedule(jcfg.n_playouts, jcfg.n_tasks,
                                    jcfg.n_workers, jcfg.scheduler)
    jtree = jt.init_tree(jcfg.tree_cap, SIZE * SIZE, 1)
    jtree = jg.run_schedule_round(jtree, jnp.asarray(empty()), jcfg, key,
                                  schedule[0], jnp.float32(1.0))
    fields = {k: np.array(getattr(jtree, k)) for k in jt.Tree._fields}
    return tcfg, jcfg, fields, np.asarray(jax.random.key_data(key)), schedule


def test_scheduler_copy_matches():
    for policy in ("fifo", "rebalance", "one_per_core", "sequential"):
        for n_playouts, n_tasks, W in [(256, 16, 8), (100, 7, 4), (64, 64, 1)]:
            a = tsched.make_schedule(n_playouts, n_tasks, W, policy)
            b = jsched.make_schedule(n_playouts, n_tasks, W, policy)
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.m == y.m
                np.testing.assert_array_equal(x.task_ids, y.task_ids)
                np.testing.assert_array_equal(x.active, y.active)
            assert tsched.schedule_stats(a) == jsched.schedule_stats(b)
        assert tsched.quantum_plan(37, 8, policy) == jsched.quantum_plan(
            37, 8, policy)


def test_next_round_from_carried_tree_matches(midsearch):
    """Stop the JAX search after round r, carry tree and key across, run
    round r+1 in both: every field equal."""
    tcfg, jcfg, fields, key_data, schedule = midsearch
    ttree = convert.tree_from_numpy(fields, "cpu")
    tkey = convert.key_from_data(key_data, "cpu")
    jtree = jt.Tree(**{k: jnp.asarray(v) for k, v in fields.items()})
    jkey = jax.random.wrap_key_data(jnp.asarray(key_data))
    ttree = tg.run_schedule_round(ttree, torch.from_numpy(empty()), tcfg,
                                  tkey, schedule[1], 1.0)
    jtree = jg.run_schedule_round(jtree, jnp.asarray(empty()), jcfg, jkey,
                                  schedule[1], jnp.float32(1.0))
    assert_trees_equal(ttree, jtree)
    tt.check_invariants(ttree)


def iteration_inputs(tkey, W, task0=100, i=3):
    task_keys = tg.fold_task_keys(tkey, torch.arange(task0, task0 + W,
                                                     dtype=torch.int32))
    return rng.fold_in(task_keys, i)


def test_one_sync_iteration_from_carried_tree_matches(midsearch):
    tcfg, jcfg, fields, key_data, _ = midsearch
    tkey = convert.key_from_data(key_data, "cpu")
    iter_keys = iteration_inputs(tkey, tcfg.n_workers)
    active = np.array([True] * 6 + [False] * 2)
    ttree = tg.sync_iteration(convert.tree_from_numpy(fields, "cpu"),
                              torch.from_numpy(empty()), tcfg, 1.0, iter_keys,
                              torch.from_numpy(active))
    jtree = jg.sync_iteration(
        jt.Tree(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(empty()), jcfg, jnp.float32(1.0), jax_keys(iter_keys),
        jnp.asarray(active))
    assert_trees_equal(ttree, jtree)


def test_select_batch_matches_jax_and_per_lane_select_one(midsearch):
    tcfg, jcfg, fields, key_data, _ = midsearch
    ttree = convert.tree_from_numpy(fields, "cpu")
    game = tcfg.game_obj
    board = torch.from_numpy(empty())
    noise_keys = rng.split(iteration_inputs(
        convert.key_from_data(key_data, "cpu"), 8), 3)[:, 0]
    got = tg.select_batch(ttree, board, game, 1.0, noise_keys, 1e-3)
    want = jg.select_batch(tree_to_jax(ttree), jnp.asarray(empty()),
                           jcfg.game_obj, jnp.float32(1.0),
                           jax_keys(noise_keys), 1e-3)
    lanes = [tg.select_one(ttree, board, game, 1.0, noise_keys[w], 1e-3)
             for w in range(8)]
    for g, w, per_lane in zip(got, want, zip(*lanes)):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, torch.stack(per_lane))
    assert int(got[1].max()) >= 1      # the descent really left the root


def test_propose_move_matches_jax(midsearch):
    tcfg, jcfg, fields, key_data, _ = midsearch
    ttree = convert.tree_from_numpy(fields, "cpu")
    jtree = tree_to_jax(ttree)
    keys = rng.split(convert.key_from_data(key_data, "cpu"), 6)
    leaves = np.array([0, 1, 2, 5, 9, 1024], np.int32)   # incl. root and PAD
    boards = np.zeros((6, 25), np.int8)
    boards[1, 3] = 1
    boards[4] = 1                                        # terminal: no move
    got = tg.propose_move(ttree, torch.from_numpy(leaves),
                          torch.from_numpy(boards), tcfg.game_obj, keys)
    want = jax.vmap(lambda l, b, k: jg.propose_move(
        jtree, l, b, jcfg.game_obj, k))(jnp.asarray(leaves),
                                        jnp.asarray(boards), jax_keys(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[4]) == -1
    one = tg.propose_move(ttree, torch.tensor(2, dtype=torch.int32),
                          torch.from_numpy(boards[2]), tcfg.game_obj, keys[2])
    assert int(one) == int(got[2])


def test_level_noise_and_advance_paths_match():
    keys = rng.split(rng.key(3, "cpu"), 4)
    depths = np.array([0, 2, 2, 5], np.int32)
    np.testing.assert_array_equal(
        tg.level_noise(keys, torch.from_numpy(depths), 25, 1e-3).numpy(),
        np.asarray(jg.level_noise(jax_keys(keys), jnp.asarray(depths), 25,
                                  1e-3)))
    paths = np.full((4, 7), 99, np.int32)
    child = np.array([5, 6, 7, 8], np.int32)
    step = np.array([True, False, True, True])
    np.testing.assert_array_equal(
        tg.advance_paths(*map(torch.from_numpy, (paths, depths, child, step))
                         ).numpy(),
        np.asarray(jg.advance_paths(*map(jnp.asarray,
                                         (paths, depths, child, step)))))


# ------------------------------------------------- the port's own oracles ----
def port_search(seed=0, **over):
    cfg = tg.GSCPMConfig(**{**KW, **over})
    return tg.gscpm_search(torch.from_numpy(empty(cfg.board_size)), 1, cfg,
                           rng.key(seed, "cpu"), device="cpu")


@pytest.mark.parametrize("vl_rounds", [1, 2])
def test_scalar_descent_and_playout_oracles_are_bit_identical(vl_rounds):
    base, _ = port_search(seed=2, vl_rounds=vl_rounds, n_playouts=128)
    for over in (dict(descent="scalar"), dict(playout="scalar")):
        other, _ = port_search(seed=2, vl_rounds=vl_rounds, n_playouts=128,
                               **over)
        assert parity.differing_fields(base, other) == []
    tt.check_invariants(base)
    assert float(base.visits[0]) == 128


@pytest.mark.parametrize("seed", [0, 5])
def test_single_lane_gscpm_equals_sequential_uct(seed):
    n = 96
    t_seq, s_seq = tmcts.uct_search(
        torch.from_numpy(empty()), 1, n, rng.key(seed, "cpu"),
        board_size=SIZE, tree_cap=1024, device="cpu")
    t_par, s_par = port_search(seed=seed, n_playouts=n, n_tasks=1,
                               n_workers=1, select_noise=0.0,
                               scheduler="sequential")
    assert parity.differing_fields(t_seq, t_par) == []
    assert s_seq["best_move"] == s_par["best_move"]
    assert float(t_seq.visits[0]) == n
    tt.check_invariants(t_seq)


def test_warm_start_continues_in_place_and_checks_the_tree():
    cfg = tg.GSCPMConfig(**{**KW, "n_playouts": 64})
    board = torch.from_numpy(empty())
    tree, _ = tg.gscpm_search(board, 1, cfg, rng.key(1, "cpu"), device="cpu")
    snapshot = parity.clone_tree(tree)
    warm, st = tg.gscpm_search(board, 1, cfg, rng.key(2, "cpu"), tree=tree,
                               device="cpu")
    assert warm.visits is tree.visits                   # updated in place
    assert float(warm.visits[0]) == 128
    assert st["reused_visits"] == 64.0
    assert st["reused_nodes"] == int(snapshot.n_nodes) - 1
    tt.check_invariants(warm)
    # same warm start in the JAX package: same tree
    jcfg = jg.GSCPMConfig(**{**KW, "n_playouts": 64})
    jwarm, _ = jg.gscpm_search(jnp.asarray(empty()), 1, jcfg,
                               jax.random.key(2), tree=tree_to_jax(snapshot))
    assert_trees_equal(warm, jwarm)
    with pytest.raises(ValueError, match="to_move"):
        tg.warm_tree_check(warm, 2, cfg)
    with pytest.raises(ValueError, match="cap"):
        tg.warm_tree_check(warm, 1, tg.GSCPMConfig(**{**KW, "tree_cap": 512}))
    with pytest.raises(ValueError, match="max_children"):
        tg.warm_tree_check(warm, 1, tg.GSCPMConfig(**{**KW, "board_size": 7}))


# ------------------------------------------------------- run-time knobs ----
def test_knob_sweep_changes_no_code_path():
    """cp, grain m and the budgets are run-time values on both sides: the
    JAX package compiles once for the sweep, the port compiles nothing at
    all, and every point of the sweep gives the same tree in both."""
    board = empty()
    base_t, base_j = both_configs(**KW)
    jg.gscpm_search(jnp.asarray(board), 1, base_j, jax.random.key(0))
    compiled = jg.run_chunk._cache_size()
    for cp, n_tasks, n_playouts in [(0.35, 16, 256), (1.7, 4, 128),
                                    (1.0, 32, 64), (0.0, 8, 192)]:
        kw = {**KW, "cp": cp, "n_tasks": n_tasks, "n_playouts": n_playouts}
        tcfg, jcfg = both_configs(**kw)
        assert tcfg == base_t and hash(tcfg) == hash(base_t)
        ttree, _ = tg.gscpm_search(torch.from_numpy(board), 1, tcfg,
                                   rng.key(9, "cpu"), device="cpu")
        jtree, _ = jg.gscpm_search(jnp.asarray(board), 1, jcfg,
                                   jax.random.key(9))
        assert_trees_equal(ttree, jtree)
    assert jg.run_chunk._cache_size() == compiled
    assert _build._lib is None and _build.last_build_seconds is None


def test_iteration_plan_reproduces_the_search():
    cfg = tg.GSCPMConfig(**{**KW, "n_playouts": 96, "n_tasks": 12})
    board = torch.from_numpy(empty())
    whole, _ = tg.gscpm_search(board, 1, cfg, rng.key(6, "cpu"), device="cpu")
    tree = tt.init_tree(cfg.tree_cap, 25, 1, device="cpu")
    for iter_keys, active in parity.iteration_plan(cfg, rng.key(6, "cpu")):
        tg.sync_iteration(tree, board, cfg, cfg.cp, iter_keys, active)
    assert parity.differing_fields(whole, tree) == []


def test_first_divergent_pick_finds_an_injected_difference(midsearch):
    tcfg, _, fields, key_data, _ = midsearch
    tree = convert.tree_from_numpy(fields, "cpu")
    board = torch.from_numpy(empty())
    iter_keys = iteration_inputs(convert.key_from_data(key_data, "cpu"), 8)
    assert parity.first_divergent_pick(tree, board, tcfg, 1.0, iter_keys,
                                       jax_select) is None

    def off_by_one_on_lane_2(*args, **kw):
        picks = jax_select(*args, **kw).clone()
        picks[2] = (picks[2] + 1) % 25
        return picks

    found = parity.first_divergent_pick(tree, board, tcfg, 1.0, iter_keys,
                                        off_by_one_on_lane_2)
    assert found["level"] == 0 and found["lane"] == 2
    assert found["other_pick"] == (found["pick"] + 1) % 25
    assert found["gap"] >= 0.0
    assert parity.differing_fields(tree, convert.tree_from_numpy(fields, "cpu")
                                   ) == []       # the replay left it untouched
