"""B token trees searched as one forest (``mcts_decode_search_batch``,
``run_chunk_batch``, ``mcts_generate_batch``): the port against the JAX
package's ``jax.vmap`` over the single-request chunk, on the same converted
weights (reduced smollm-135m, 2 layers, float32; the JAX side's Pallas
flash kernel in interpret mode).

- ``tests/test_serve.py::test_mcts_decode_batch_mixed_lengths``' case (3
  requests of lengths 6/4/5, the third masked; 24 playouts, 6 tasks, W 4,
  branch 4, depth 3, rollout 3, cap 128): every member's integer fields
  and visits equal, wins within 1e-5 (``decode_tree_parts``), the stats
  equal; the masked member stays at one node with best token -1;
- ``mcts_generate_batch`` commits the reference's tokens;
- the forest helpers equal the single tree's, member by member: the
  descent (one ``uct_select`` call a level for all B·W lanes), the path
  tokens, the proposals and the backup (every member's PAD row zeroed,
  wins added lane by lane: equal to the bit).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core import root_parallel as jrp
from repro.models import api as japi
from repro.serve import mcts_decode as jmd
from repro_torch import convert, rng
from repro_torch.core import tree as tt
from repro_torch.core.root_parallel import check_forest_invariants
from repro_torch.serve import mcts_decode as tmd
from torch_parity_util import decode_tree_parts, tree_to_jax

torch.set_num_threads(1)

DKW = dict(n_playouts=24, n_tasks=6, n_workers=4, branch=4, max_depth=3,
           rollout_len=3, tree_cap=128)
LENS = np.array([6, 4, 5], np.int32)
MASK = np.array([True, True, False])


def model_pair(seed: int, flash: bool):
    jcfg = jreduced("smollm-135m").replace(use_flash=flash)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    jp = japi.init_params(jcfg, jax.random.key(seed))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def lm():
    return model_pair(0, False)


def mixed_prompts() -> np.ndarray:
    prompts = np.zeros((3, 6), np.int32)
    prompts[0, :6] = np.arange(1, 7)
    prompts[1, :4] = np.arange(2, 6)
    prompts[2, :5] = 7
    return prompts


def port_search(lm, prompts, seed=2, mask=MASK, lens=LENS, **kw):
    _, _, tcfg, tp = lm
    return tmd.mcts_decode_search_batch(
        tp, tcfg, prompts, tmd.MCTSDecodeConfig(**{**DKW, **kw}),
        rng.key(seed, "cpu"), prompt_lens=lens, request_mask=mask,
        device="cpu")


def member_parts(forest, jforest) -> list:
    return [decode_tree_parts(tt.forest_member(forest, b),
                              jax.tree.map(lambda x: x[b], jforest))
            for b in range(tt.forest_size(forest))]


@pytest.fixture(scope="module")
def searched(lm):
    """A port forest after the mixed-lengths search (seed 2)."""
    return port_search(lm, mixed_prompts())


STAT_KEYS = ("n_requests", "n_active_requests", "playouts",
             "playouts_per_request", "grain", "tree_nodes", "best_tokens",
             "root_children")


@pytest.mark.parametrize("seed,flash", [(2, False), (3, True)])
def test_batch_search_equals_reference(seed, flash):
    jcfg, jp, tcfg, tp = pair = model_pair(seed, flash)
    prompts = mixed_prompts()
    forest, stats = port_search(pair, prompts, seed=seed)
    jforest, jstats = jmd.mcts_decode_search_batch(
        jp, jcfg, jnp.asarray(prompts), jmd.MCTSDecodeConfig(**DKW),
        jax.random.key(seed), prompt_lens=jnp.asarray(LENS),
        request_mask=jnp.asarray(MASK))
    assert member_parts(forest, jforest) == [[], [], []]
    assert {k: stats[k] for k in STAT_KEYS} == {k: jstats[k]
                                                for k in STAT_KEYS}
    # 6 tasks of grain 4 on 4 lanes: two rounds of 4 iterations
    assert stats["sync_iterations"] == 8 and stats["prefill_s"] > 0


def test_masked_member_stays_empty(lm, searched):
    forest, stats = searched
    assert stats["n_active_requests"] == 2 and stats["playouts"] == 48
    assert all(n > 1 for n in stats["tree_nodes"][:2])
    assert stats["tree_nodes"][2] == 1 and stats["best_tokens"][2] == -1
    assert all(0 <= t < 512 for t in stats["best_tokens"][:2])
    assert all(0 < c <= 4 for c in stats["root_children"][:2])
    np.testing.assert_allclose(forest.visits[:2, 0].numpy(), 24.0)
    assert float(forest.visits[2].abs().sum()) == 0.0
    check_forest_invariants(tt.Tree(*(x[:2] for x in forest)),
                            discrete_credits=False)


def test_batch_search_runs_twice_bit_identically(lm, searched):
    forest, stats = port_search(lm, mixed_prompts())
    for a, b in zip(forest, searched[0]):
        assert torch.equal(a, b)
    assert stats["best_tokens"] == searched[1]["best_tokens"]


def test_all_members_masked_search_nothing(lm):
    forest, stats = port_search(lm, mixed_prompts(),
                                mask=np.zeros(3, bool))
    assert stats["tree_nodes"] == [1, 1, 1]
    assert stats["best_tokens"] == [-1, -1, -1] and stats["playouts"] == 0


@pytest.mark.parametrize("lens", [[0, 4, 5], [6, 7, 5]])
def test_prompt_lengths_outside_the_matrix_raise(lm, lens):
    with pytest.raises(ValueError, match="prompt_lens"):
        port_search(lm, mixed_prompts(), lens=np.array(lens, np.int32))


def test_generate_batch_commits_the_reference_tokens(lm):
    jcfg, jp, tcfg, tp = lm
    kw = {**DKW, "n_playouts": 16, "n_tasks": 4}
    prompts = mixed_prompts()
    got, glens, gstats = tmd.mcts_generate_batch(
        tp, tcfg, prompts, LENS, 3, tmd.MCTSDecodeConfig(**kw),
        rng.key(4, "cpu"), device="cpu")
    want, wlens, wstats = jmd.mcts_generate_batch(
        jp, jcfg, prompts, LENS, 3, jmd.MCTSDecodeConfig(**kw),
        jax.random.key(4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(glens, wlens)
    assert got.shape == (3, 9) and got.dtype == np.int32
    assert glens.tolist() == (LENS + 3).tolist()
    for g, w in zip(gstats, wstats):
        assert g["best_tokens"] == w["best_tokens"]
        assert g["tree_nodes"] == w["tree_nodes"]


def test_forest_descent_equals_each_member_with_one_tile_a_level(
        searched, monkeypatch):
    forest, _ = searched
    cfg = tmd.MCTSDecodeConfig(**DKW)
    keys = rng.split(rng.key(9, "cpu"), 3 * 6).view(3, 6, 2)
    calls = []
    orig = tmd.ops.uct_select

    def counting(wins, *a, **k):
        calls.append(tuple(wins.shape))
        return orig(wins, *a, **k)

    monkeypatch.setattr(tmd.ops, "uct_select", counting)
    paths, depths, leaves = tmd.select_token_batch(forest, cfg, 0.7, keys)
    levels = len(calls)
    monkeypatch.setattr(tmd.ops, "uct_select", orig)
    assert int(depths.max()) >= 1
    assert calls == [(18, 4)] * levels            # one (B·W, C) tile a level
    assert levels == int(depths.max()) + 1
    for b in range(3):
        member = tt.forest_member(forest, b)
        p, d, n = tmd.select_token_batch(member, cfg, 0.7, keys[b])
        assert torch.equal(p, paths[b]) and torch.equal(d, depths[b])
        assert torch.equal(n, leaves[b])
        assert torch.equal(tmd.path_tokens(member, p, 3),
                           tmd.path_tokens(forest, paths, 3)[b])
        # and the scalar oracle, lane by lane
        for w in range(6):
            ps, ds, ns = tmd.select_token_path(member, cfg, keys[b, w], cp=0.7)
            assert torch.equal(ps, paths[b, w]) and int(ns) == int(leaves[b, w])
    jpaths, jdepths, jleaves = jax.vmap(
        lambda t, k: jmd.select_token_batch(t, jmd.MCTSDecodeConfig(**DKW),
                                            jnp.float32(0.7), k))(
        tree_to_jax(forest), jax.random.wrap_key_data(
            jnp.asarray(keys.numpy().astype(np.uint32))))
    np.testing.assert_array_equal(paths.numpy(), np.asarray(jpaths))
    np.testing.assert_array_equal(leaves.numpy(), np.asarray(jleaves))


def test_forest_proposals_equal_each_member(searched):
    forest, _ = searched
    cfg = tmd.MCTSDecodeConfig(**DKW)
    r = np.random.default_rng(1)
    logits = torch.from_numpy(
        (np.round(r.normal(size=(3, 5, 512)) * 2) / 2).astype(np.float32))
    n = forest.n_nodes.numpy()
    leaves = torch.from_numpy(np.stack([r.integers(0, k, 5) for k in n])
                              .astype(np.int32))
    depths = torch.from_numpy(r.integers(0, 4, (3, 5)).astype(np.int32))
    keys = rng.split(rng.key(4, "cpu"), 15).view(3, 5, 2)
    got = tmd.propose_token(forest, leaves, logits, cfg, depths, keys)
    for b in range(3):
        one = tmd.propose_token(tt.forest_member(forest, b), leaves[b],
                                logits[b], cfg, depths[b], keys[b])
        assert torch.equal(got[b], one)


def random_forest_paths(cap, B, W, D, seed):
    r = np.random.default_rng(seed)
    paths = np.full((B, W, D), cap, np.int32)
    for b in range(B):
        for w in range(W):
            k = r.integers(1, D)
            paths[b, w, :k] = np.concatenate(
                [[0], r.choice(np.arange(1, 20), k - 1, replace=False)])
    return (paths, np.exp(-r.random((B, W)) * 5).astype(np.float32),
            (r.random((B, W)) > 0.2).astype(np.float32), r)


def test_forest_backup_equals_member_backups_to_the_bit():
    cap, B, W, D = 64, 3, 16, 6
    paths, values, weights, r = random_forest_paths(cap, B, W, D, 5)
    forest = tt.init_forest(B, cap, 4, 1, device="cpu")
    forest.visits.copy_(torch.from_numpy(
        r.integers(0, 9, (B, cap + 1)).astype(np.float32)))
    forest.wins.copy_(torch.from_numpy(
        r.random((B, cap + 1)).astype(np.float32)))
    # a member's PAD row holding stale values must come back zero
    forest.visits[:, cap] = 3.0
    forest.wins[:, cap] = 0.5
    members = [tt.Tree(*(x[b].clone() for x in forest)) for b in range(B)]
    # a copy: the port's backup writes in place, where JAX returns a tree
    jforest = tree_to_jax(tt.Tree(*(x.clone() for x in forest)))
    tmd.backup_values(forest, torch.from_numpy(paths),
                      torch.from_numpy(values), torch.from_numpy(weights))
    assert float(forest.visits[:, cap].abs().sum()) == 0.0
    assert float(forest.wins[:, cap].abs().sum()) == 0.0
    for b, m in enumerate(members):
        tmd.backup_values(m, torch.from_numpy(paths[b]),
                          torch.from_numpy(values[b]),
                          torch.from_numpy(weights[b]))
        assert torch.equal(forest.wins[b], m.wins)
        assert torch.equal(forest.visits[b], m.visits)
    want = jax.vmap(jmd.backup_values)(jforest, jnp.asarray(paths),
                                       jnp.asarray(values),
                                       jnp.asarray(weights))
    np.testing.assert_array_equal(forest.wins.numpy(), np.asarray(want.wins))
    np.testing.assert_array_equal(forest.visits.numpy(),
                                  np.asarray(want.visits))


def test_forest_invariants_hold_in_the_reference_checker(searched):
    forest, _ = searched
    jrp.check_forest_invariants(
        jax.tree.map(lambda x: x[:2], tree_to_jax(forest)),
        discrete_credits=False)


def test_stepping_a_batch_against_itself_never_parts(lm, searched):
    """``parity.step_decode_search_batch`` (the card's kernels-vs-plain
    report for the batch) on the CPU, where both runs are the plain
    versions: no parting, and it ends on the search's own tokens."""
    from repro_torch import parity
    from repro_torch.kernels import ops
    _, _, tcfg, tp = lm
    rep = parity.step_decode_search_batch(
        tp, tcfg, tmd.MCTSDecodeConfig(**DKW),
        torch.from_numpy(mixed_prompts()), rng.key(2, "cpu"),
        ops.plain_versions, prompt_lens=LENS, request_mask=MASK)
    assert rep["iterations"] == rep["of"] == 8
    assert rep["root_err"] == rep["leaf_err"] == rep["rollout_err"] == 0.0
    assert rep["partings"] == 0 and rep["parted_at"] is None
    assert rep["best_tokens"] == [searched[1]["best_tokens"]] * 2


def test_stepping_a_batch_excuses_partings_of_a_perturbed_model(lm,
                                                                 monkeypatch):
    """Logits moved by a few bf16 steps in one run: every flipped decision
    sits within twice the measured error and names its member."""
    from repro_torch import parity
    from repro_torch.models import api as tapi
    import contextlib
    _, _, tcfg, tp = lm
    g = torch.Generator().manual_seed(0)
    decode = tapi.decode

    @contextlib.contextmanager
    def noisy():
        def run(*a, **k):
            logits, cache = decode(*a, **k)
            return logits + 0.05 * torch.randn(logits.shape, generator=g), cache
        monkeypatch.setattr(tapi, "decode", run)
        try:
            yield
        finally:
            monkeypatch.setattr(tapi, "decode", decode)

    rep = parity.step_decode_search_batch(
        tp, tcfg, tmd.MCTSDecodeConfig(**{**DKW, "n_playouts": 16,
                                          "n_tasks": 4}),
        torch.from_numpy(mixed_prompts()), rng.key(0, "cpu"), noisy,
        prompt_lens=LENS, request_mask=MASK)
    assert 0 < rep["root_err"] and 0 < rep["leaf_err"]
    assert rep["partings"] > 0 and rep["unexcused"] == []
    assert rep["first"]["member"] in (0, 1, 2)
