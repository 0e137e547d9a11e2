"""GSCPM-guided LM decoding: the port against the JAX package on the same
converted weights (reduced smollm-135m, 2 layers), and against itself.

- the scalar descent oracle equals the batched descent, exactly;
- the proposal's top-k puts the lower token id first on tied logits, as
  ``lax.top_k`` does, where ``torch.topk`` does not promise an order;
- the float backup adds in the reference's order: equal to the bit;
- whole searches (W=4, branch 4, depth 3, rollout 3, 24 playouts, tree_cap
  128; two seeds; flash on and off) give trees whose integer fields and
  visits equal the reference's and whose wins agree to 1e-5 (the values
  are exp(mean log-prob) from float32 logits, computed in another order),
  or part only at a decision within 1e-5 (``torch_parity_util``);
- ``mcts_generate`` emits the reference's tokens; root visits == playouts.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core import tree as jt
from repro.models import api as japi
from repro.serve import mcts_decode as jmd
from repro_torch import convert, parity, rng
from repro_torch.core import tree as tt
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.serve import mcts_decode as tmd
from torch_parity_util import (assert_same_decode_search, decode_tree_parts,
                               explain_decode_divergence, jax_keys,
                               tree_to_jax)

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

DKW = dict(n_workers=4, branch=4, max_depth=3, rollout_len=3, n_playouts=24,
           n_tasks=6, tree_cap=128)


def model_pair(seed: int, flash: bool):
    jcfg = jreduced("smollm-135m").replace(use_flash=flash)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    jp = japi.init_params(jcfg, jax.random.key(seed))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def prompt_for(seed: int, n: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


@pytest.fixture(scope="module")
def searched():
    """A port tree after a short search (for the descent/proposal tests)."""
    jcfg, jp, tcfg, tp = model_pair(0, False)
    tree, _ = tmd.mcts_decode_search(
        tp, tcfg, torch.from_numpy(prompt_for(0)),
        tmd.MCTSDecodeConfig(**{**DKW, "n_playouts": 48}),
        rng.key(0, "cpu"), device="cpu")
    return tree


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_search_tree_equals_reference(seed, flash):
    jcfg, jp, tcfg, tp = model_pair(seed, flash)
    tree, stats = assert_same_decode_search(jcfg, jp, tcfg, tp,
                                            prompt_for(seed), DKW, seed)
    tt.check_invariants(tree, discrete_credits=False)
    assert float(tree.visits[0]) == stats["playouts"] == 24
    # 6 tasks of grain 4 on 4 lanes: two rounds of 4 iterations, the second
    # with two lanes masked
    assert stats["sync_iterations"] == 8 and stats["root_children"] > 0


def test_generate_emits_the_reference_tokens():
    jcfg, jp, tcfg, tp = model_pair(2, True)
    cfg = {**DKW, "n_playouts": 16, "n_tasks": 4}
    prompt = prompt_for(2, 6)
    got, tstats = tmd.mcts_generate(tp, tcfg, torch.from_numpy(prompt), 2,
                                    tmd.MCTSDecodeConfig(**cfg),
                                    rng.key(2, "cpu"), device="cpu",
                                    keep_trees=True)
    want, jstats = jmd.mcts_generate(jp, jcfg, jnp.asarray(prompt), 2,
                                     jmd.MCTSDecodeConfig(**cfg),
                                     jax.random.key(2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and got.shape == (8,)
    for ts, js in zip(tstats, jstats):
        assert ts["best_token"] == js["best_token"]
        assert float(ts["tree"].visits[0]) == ts["playouts"] == 16


def test_scalar_descent_oracle_equals_batched(searched):
    tree = searched
    cfg = tmd.MCTSDecodeConfig(**DKW)
    keys = rng.split(rng.key(9, "cpu"), 6)
    paths, depths, leaves = tmd.select_token_batch(tree, cfg, 0.7, keys)
    assert int(depths.max()) >= 1   # the tree is deep enough to descend
    for w in range(6):
        p, d, n = tmd.select_token_path(tree, cfg, keys[w], cp=0.7)
        assert torch.equal(p, paths[w]) and int(d) == int(depths[w])
        assert int(n) == int(leaves[w])


def test_scalar_descent_search_equals_batched_search():
    _, _, tcfg, tp = model_pair(3, False)
    run = lambda descent: tmd.mcts_decode_search(
        tp, tcfg, torch.from_numpy(prompt_for(3)),
        tmd.MCTSDecodeConfig(**{**DKW, "descent": descent}),
        rng.key(3, "cpu"), device="cpu")[0]
    assert parity.differing_fields(run("batched"), run("scalar")) == []


def test_top_k_puts_the_lower_token_first_on_ties():
    """Logits on a coarse grid (as bf16 logits are at full vocabulary):
    ties are everywhere; the order equals lax.top_k's, and torch.topk is
    not relied on."""
    r = np.random.default_rng(0)
    logits = (np.round(r.normal(size=(16, 2048)) * 4) / 4).astype(np.float32)
    logits[0, ::3] = 5.0          # a row where every third token ties on top
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits), 8)[1])
    got = tmd.top_k_tokens(torch.from_numpy(logits), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), np.arange(0, 24, 3))


def test_propose_token_matches_reference_on_tied_logits(searched):
    tree = searched
    cfg = tmd.MCTSDecodeConfig(**DKW)
    W = 8
    r = np.random.default_rng(1)
    # quantized logits: the top-k boundary and order sit on ties
    logits = (np.round(r.normal(size=(W, 512)) * 2) / 2).astype(np.float32)
    n = int(tree.n_nodes)
    leaves = r.integers(0, n, W).astype(np.int32)
    depths = r.integers(0, 4, W).astype(np.int32)
    keys = rng.split(rng.key(4, "cpu"), W)
    got = tmd.propose_token(tree, torch.from_numpy(leaves),
                            torch.from_numpy(logits), cfg,
                            torch.from_numpy(depths), keys)
    jtree = tree_to_jax(tree)
    want = jax.vmap(lambda l, ll, d, k: jmd.propose_token(
        jtree, l, ll, jmd.MCTSDecodeConfig(**DKW), d, k))(
        jnp.asarray(leaves), jnp.asarray(logits), jnp.asarray(depths),
        jax_keys(keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[depths >= 3] == -1).all()     # at the horizon: no proposal


def test_backup_values_equals_reference_to_the_bit():
    """Float wins added lane by lane reproduce XLA's sequential scatter-add
    exactly (and the same order on the card makes runs repeatable)."""
    cap, W, D = 64, 16, 6
    r = np.random.default_rng(5)
    tree = tt.init_tree(cap, 4, 1, device="cpu")
    tree.visits.copy_(torch.from_numpy(
        r.integers(0, 9, cap + 1).astype(np.float32)))
    tree.wins.copy_(torch.from_numpy(r.random(cap + 1).astype(np.float32)))
    tree.visits[cap] = tree.wins[cap] = 0.0
    # every lane's path: the root, distinct nodes, then PAD
    paths = np.full((W, D), cap, np.int32)
    for w in range(W):
        k = r.integers(1, D)
        paths[w, :k] = np.concatenate([[0], r.choice(np.arange(1, 20), k - 1,
                                                     replace=False)])
    values = np.exp(-r.random(W) * 5).astype(np.float32)
    weights = (r.random(W) > 0.2).astype(np.float32)
    jtree = jmd.backup_values(tree_to_jax(tree), jnp.asarray(paths),
                              jnp.asarray(values), jnp.asarray(weights))
    tmd.backup_values(tree, torch.from_numpy(paths), torch.from_numpy(values),
                      torch.from_numpy(weights))
    np.testing.assert_array_equal(tree.wins.numpy(), np.asarray(jtree.wins))
    np.testing.assert_array_equal(tree.visits.numpy(), np.asarray(jtree.visits))


def test_divergence_explainer_steps_both_packages():
    """The side-by-side stepping used on a mismatch runs end to end: on two
    searches that do NOT part it must say so."""
    jcfg, jp, tcfg, tp = model_pair(0, False)
    kw = {**DKW, "n_playouts": 8, "n_tasks": 2}
    with pytest.raises(AssertionError, match="found no difference"):
        explain_decode_divergence(jcfg, jp, tcfg, tp, prompt_for(0), kw, 0,
                                  ["wins"])


@contextlib.contextmanager
def patched(module, name, fn):
    """Inside the context ``module.name`` is ``fn(original)``."""
    orig = getattr(module, name)
    setattr(module, name, fn(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


STEP_KW = {**DKW, "n_playouts": 16, "n_tasks": 4}


def step_search(other, seed=0):
    _, _, tcfg, tp = model_pair(seed, False)
    return parity.step_decode_search(
        tp, tcfg, tmd.MCTSDecodeConfig(**STEP_KW),
        torch.from_numpy(prompt_for(seed)), rng.key(seed, "cpu"), other)


def test_stepping_a_search_against_itself_never_parts():
    """On the CPU the kernels' dispatch IS the plain version: the stepped
    pair agrees to the bit and ends on the search's own token."""
    _, _, tcfg, tp = model_pair(0, False)
    _, stats = tmd.mcts_decode_search(
        tp, tcfg, torch.from_numpy(prompt_for(0)),
        tmd.MCTSDecodeConfig(**STEP_KW), rng.key(0, "cpu"), device="cpu")
    rep = step_search(ops.plain_versions)
    assert rep["iterations"] == rep["of"] == stats["sync_iterations"] == 4
    assert rep["root_err"] == rep["leaf_err"] == rep["rollout_err"] == 0.0
    assert rep["partings"] == 0 and rep["parted_at"] is None
    assert rep["best_tokens"] == [stats["best_token"]] * 2


def test_stepping_excuses_partings_of_a_perturbed_model():
    """Logits moved by a few bf16 steps: the decisions that flip all sit
    within twice the measured logit error."""
    g = torch.Generator().manual_seed(0)

    def noisy(decode):
        def run(*a, **k):
            logits, cache = decode(*a, **k)
            return logits + 0.05 * torch.randn(logits.shape, generator=g), cache
        return run
    rep = step_search(lambda: patched(tapi, "decode", noisy))
    assert 0 < rep["leaf_err"] and 0 < rep["rollout_err"] <= 0.5
    assert rep["partings"] > 0 and rep["unexcused"] == []
    assert rep["first"]["decision"] in {"uct_pick", "top_k", "rollout_first",
                                        "rollout_sample"}


def test_stepping_flags_a_wrong_uct_pick():
    """A selection that ignores the scores (always the last valid child)
    parts at a UCT pick on equal scores: the wrong run's own margin is
    negative, and no error excuses it."""
    def last_valid(select):
        def run(wins, visits, vloss, ptot, valid, cp, noise=None,
                lane_mask=None):
            return (valid.sum(-1) - 1).clamp(min=0).to(torch.int32)
        return run
    rep = step_search(lambda: patched(ops, "uct_select", last_valid))
    assert rep["parted_at"] is not None and rep["best_tokens"][0] != -1
    bad = rep["unexcused"]
    assert bad and bad[0]["decision"] == "uct_pick" and bad[0]["err"] == 0.0
    assert bad[0]["gaps"][0] > 0 > bad[0]["gaps"][1]


def test_tree_comparison_tolerates_only_wins_rounding():
    tree = tt.init_tree(8, 4, 1, device="cpu")
    jtree = jt.init_tree(8, 4, 1)
    assert decode_tree_parts(tree, jtree) == []
    tree.wins[0] = 1e-7
    assert decode_tree_parts(tree, jtree) == ["wins"]
    tree.wins[0] = 0.0
    tree.visits[0] = 1.0
    assert decode_tree_parts(tree, jtree) == ["visits"]


@pytest.mark.parametrize("call", ["extras"])
def test_batch_extras_match_reference(call):
    """``batch_extras`` was refused until the vlm and encdec families were
    ported. On this dense model the reference's
    prefill ignores ``patches``: the search with them gives the
    reference's tree, and the same tree as without them."""
    jcfg, jp, tcfg, tp = model_pair(0, False)
    prompt = prompt_for(0)
    extras = {"patches": np.zeros((1, 2, 3), np.float32)}
    tree, _ = assert_same_decode_search(jcfg, jp, tcfg, tp, prompt, DKW,
                                        seed=0, extras=extras)
    plain, _ = tmd.mcts_decode_search(
        tp, tcfg, torch.from_numpy(prompt), tmd.MCTSDecodeConfig(**DKW),
        rng.key(0, "cpu"), device="cpu")
    assert parity.differing_fields(tree, plain) == []
