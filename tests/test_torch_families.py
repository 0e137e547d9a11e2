"""The port's MoE, MLA, Mamba-2 / zamba2 hybrid and xLSTM models against the
JAX package's, on the same converted parameters
(``convert.params_from_numpy``): the reduced twins of
``qwen3-moe-235b-a22b`` (2 MoE layers), ``deepseek-v2-236b`` (a dense MLA
layer, then 2 MoE layers with shared experts), ``zamba2-7b`` (2 zamba2
segments of 6 Mamba-2 blocks and a shared attention block, then one more
Mamba-2 block) and ``xlstm-1.3b`` (2 segments of 7 mLSTM + 1 sLSTM), float32.

Tolerance: every compared value within ``TOL`` times the largest magnitude
of the reference's (float32 sums run in another order in XLA:CPU and
PyTorch; observed ~5e-7 for the 2-3 layer twins). The xLSTM twin has 16
layers, and its exponential gates carry each layer's ~5e-7 through the
residual stream: observed up to ~2e-5 there, so it is held to
``TOL_DEEP``. The blocks' own twins of ``tests/test_models_consistency.py``
keep that file's tolerances.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.models import xlstm as jxlstm
from repro.models.common import ModelConfig as JModelConfig
from repro.models.common import init_tree as jinit_tree
from repro.models.common import spec_with_dtype as jspec_with_dtype
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)

TOL = 1e-5
TOL_DEEP = 1e-4
FAMILIES = ("qwen3-moe-235b-a22b", "deepseek-v2-236b", "zamba2-7b",
            "xlstm-1.3b")


def tol_for(arch: str) -> float:
    return TOL_DEEP if arch == "xlstm-1.3b" else TOL


def pair(arch: str, seed: int, **kw):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jconfigs.reduced_config(arch).replace(**kw)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    jp = japi.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.array(a.astype(jnp.float32)), jp)
    return jcfg, jp, tcfg, convert.params_from_numpy(tree, tcfg, "cpu")


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, tol=TOL, what=""):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def jax_leaves(tree) -> dict:
    return {".".join(str(k.key) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_same_cache(tc, jc, tol, what):
    want, got = jax_leaves(jc), dict(tree_leaves(tc))
    assert set(got) == set(want), what
    for name in want:
        assert str(got[name].dtype) == f"torch.{want[name].dtype}", (what, name)
        assert_close(got[name], want[name], tol, f"{what} {name}")


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


# ------------------------------------------------------ whole models ----
@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_cache_and_decode_match_reference(arch, flash):
    """Prefill logits, every cache leaf, and three decode steps' logits and
    caches. With ``use_flash`` the JAX side runs its Pallas kernel in
    interpret mode; MLA's v head dim differs from its q/k head dim, and
    there both packages refuse (the reference's wrapper fails reshaping its
    padded v; the port raises ``ValueError`` naming both dims)."""
    jcfg, jp, tcfg, tp = pair(arch, 0, use_flash=flash)
    B, P, max_len = 2, 16, 21
    toks = tokens(1, (B, P))
    if flash and jcfg.use_mla:
        with pytest.raises(TypeError, match="reshape"):
            japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len)
        with pytest.raises(ValueError, match="v head dim 32 differs from the "
                                             "q/k head dim 48"):
            tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, max_len)
        return
    tol = tol_for(arch)
    jl, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, max_len)
    assert tl.shape == (B, 1, jcfg.vocab) and tl.dtype == torch.float32
    assert_close(tl, jl, tol, "prefill logits")
    assert_same_cache(tc, jc, tol, "prefill cache")
    for s in range(3):
        tok = tokens(2 + s, (B, 1))
        jl, jc = japi.decode(jp, jcfg, jnp.asarray(tok), P + s, jc)
        tl, tc = tapi.decode(tp, tcfg, torch.from_numpy(tok), P + s, tc)
        assert_close(tl, jl, tol, f"decode {s} logits")
    assert_same_cache(tc, jc, tol, "decode cache")


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-7b"])
def test_decode_at_per_row_positions_matches_reference(arch):
    """Every row at its own position (MLA's latent cache, the zamba2
    segments' attention caches), and an out-of-range one is refused."""
    jcfg, jp, tcfg, tp = pair(arch, 1)
    B, P, max_len = 3, 8, 12
    toks = tokens(4, (B, P))
    _, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len)
    _, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, max_len)
    pos = np.array([8, 10, 11], np.int32)
    tok = np.array([[1], [2], [3]], np.int32)
    jl, jc = japi.decode(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc)
    tl, tc = tapi.decode(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
                         tc)
    assert_close(tl, jl, TOL, "logits")
    assert_same_cache(tc, jc, TOL, "cache")
    with pytest.raises(IndexError):
        tapi.decode(tp, tcfg, torch.from_numpy(tok), max_len, tc)


@pytest.mark.parametrize("arch", FAMILIES)
def test_hidden_states_match_reference(arch):
    """The forward paths (``lm_hidden``: the sLSTM forward, the Mamba-2 and
    zamba2 forwards, MoE and MLA attention without a cache)."""
    jcfg, jp, tcfg, tp = pair(arch, 2)
    toks = tokens(5, (2, 12))
    want, _ = jtfm.lm_hidden(jp, jcfg, jnp.asarray(toks))
    got = ttfm.lm_hidden(tp, tcfg, torch.from_numpy(toks))
    assert_close(got, want, tol_for(arch), "hidden")


def test_recurrent_decode_ignores_positions():
    """As in the reference, the recurrent blocks read no position: an xLSTM
    decode step at any ``pos`` gives the same logits and state."""
    _, _, tcfg, tp = pair("xlstm-1.3b", 3)
    toks = torch.from_numpy(tokens(6, (2, 8)))
    outs = []
    for pos in (8, 500):
        _, cache = tapi.prefill(tp, tcfg, {"tokens": toks}, 12)
        logits, cache = tapi.decode(tp, tcfg, toks[:, :1], pos, cache)
        outs.append((logits, cache))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves(outs[0][1]), tree_leaves(outs[1][1])))


# ------------------------------------------------------------- blocks ----
def block_pair(spec_fn, cfg_kw: dict, seed: int):
    jcfg = JModelConfig(**cfg_kw)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    jp = jinit_tree(jspec_with_dtype(spec_fn(jcfg), jnp.float32),
                    jax.random.key(seed))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, tcfg, tp


def normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


XLSTM_KW = dict(family="xlstm", d_model=64, n_heads=4, vocab=64,
                mlstm_chunk=16)
SSM_KW = dict(family="ssm", d_model=64, n_heads=4, vocab=64, ssm_state=16,
              ssm_headdim=16, ssm_chunk=8)


def test_mlstm_chunked_matches_reference():
    """``_mlstm_chunked`` (4 chunks: the cross-chunk state passing) and
    its decode cache against the JAX package's."""
    jcfg, jp, tcfg, tp = block_pair(jxlstm.mlstm_specs, XLSTM_KW, 0)
    x = normal(1, (2, 64, 64), 0.5)
    jy, jc = jxlstm._mlstm_chunked(jp, jcfg, jnp.asarray(x))
    ty, tc = txlstm._mlstm_chunked(tp, tcfg, torch.from_numpy(x))
    assert_close(ty, jy, TOL, "y")
    for k in jc:
        assert_close(tc[k], jc[k], TOL, k)


def test_mamba2_multichunk_matches_reference():
    """The chunked SSD with 4 chunks (the inter-chunk triangular product)
    and its decode cache against the JAX package's."""
    jcfg, jp, tcfg, tp = block_pair(jssm.mamba2_specs, SSM_KW, 1)
    x = normal(2, (2, 32, 64), 0.5)
    jy, jc = jssm.mamba2_forward(jp, jcfg, jnp.asarray(x), return_cache=True)
    ty, tc = tssm.mamba2_forward(tp, tcfg, torch.from_numpy(x),
                                 return_cache=True)
    assert_close(ty, jy, TOL, "y")
    for k in jc:
        assert_close(tc[k], jc[k], TOL, k)


# the port's twins of tests/test_models_consistency.py, at its tolerances
def test_mlstm_chunked_equals_quadratic():
    _, _, cfg, p = block_pair(jxlstm.mlstm_specs, XLSTM_KW, 0)
    x = torch.from_numpy(normal(1, (2, 64, 64), 0.5))
    y_c, cache_c = txlstm._mlstm_chunked(p, cfg, x)
    full = cfg.replace(mlstm_chunk=0)
    y_f = txlstm.mlstm_forward(p, full, x)
    _, cache_f = txlstm.mlstm_prefill(p, full, x)
    np.testing.assert_allclose(y_c.numpy(), y_f.numpy(), atol=3e-5, rtol=3e-4)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(cache_c[k].numpy(), cache_f[k].numpy(),
                                   atol=5e-5, rtol=5e-4)


def test_mlstm_chunked_then_decode():
    """Chunked prefill state continues correctly through decode steps."""
    _, _, cfg, p = block_pair(jxlstm.mlstm_specs, dict(
        XLSTM_KW, d_model=32, n_heads=2, mlstm_chunk=8), 2)
    x = torch.from_numpy(normal(3, (1, 40, 32), 0.5))
    y_full = txlstm.mlstm_forward(p, cfg.replace(mlstm_chunk=0), x)
    _, cache = txlstm.mlstm_prefill(p, cfg, x[:, :32])
    outs = []
    for t in range(32, 40):
        yt, cache = txlstm.mlstm_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(yt)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               y_full[:, 32:].numpy(), atol=2e-4, rtol=2e-3)


def test_mlstm_decode_from_init_cache():
    """From ``mlstm_init_cache`` (m = -inf) the recurrence equals the
    quadratic form token by token, as it does from a zero cache."""
    _, _, cfg, p = block_pair(jxlstm.mlstm_specs, XLSTM_KW, 4)
    x = torch.from_numpy(normal(5, (2, 12, 64), 0.5))
    y_full = txlstm.mlstm_forward(p, cfg, x)
    for cache in (txlstm.mlstm_init_cache(cfg, 2, torch.float32),
                  {k: torch.zeros_like(v) for k, v in
                   txlstm.mlstm_init_cache(cfg, 2, torch.float32).items()}):
        outs = []
        for t in range(12):
            yt, cache = txlstm.mlstm_decode(p, cfg, x[:, t:t + 1], cache)
            outs.append(yt)
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(),
                                   atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("start", [16, 0], ids=["prefill", "init_cache"])
def test_slstm_prefill_then_decode(start):
    """The sLSTM scan's final state (or ``slstm_init_cache``) continues
    through decode steps as the scan over the whole sequence does."""
    _, _, cfg, p = block_pair(jxlstm.slstm_specs, XLSTM_KW, 6)
    x = torch.from_numpy(normal(7, (2, 20, 64), 0.5))
    y_full = txlstm.slstm_forward(p, cfg, x)
    if start:
        _, cache = txlstm.slstm_prefill(p, cfg, x[:, :start])
    else:
        cache = txlstm.slstm_init_cache(cfg, 2, torch.float32)
    outs = []
    for t in range(start, 20):
        yt, cache = txlstm.slstm_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(yt)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               y_full[:, start:].numpy(), atol=1e-5, rtol=1e-4)


def test_mamba2_forward_equals_decode():
    _, _, cfg, p = block_pair(jssm.mamba2_specs, SSM_KW, 4)
    x = torch.from_numpy(normal(5, (2, 32, 64), 0.5))
    y, cache = tssm.mamba2_forward(p, cfg, x, return_cache=True)
    cache_d = tssm.mamba2_init_cache(cfg, 2, torch.float32)
    outs = []
    for t in range(32):
        yt, cache_d = tssm.mamba2_decode(p, cfg, x[:, t:t + 1], cache_d)
        outs.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.cat(outs, 1).numpy(),
                               atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(cache["state"].numpy(), cache_d["state"].numpy(),
                               atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("seed,chunk,L", [(0, 4, 16), (11, 8, 32),
                                          (12, 16, 48), (13, 4, 48),
                                          (14, 8, 16)])
def test_mamba2_chunk_invariance(seed, chunk, L):
    """SSD output independent of the chunking grain."""
    _, _, cfg, p = block_pair(jssm.mamba2_specs, dict(
        SSM_KW, d_model=32, n_heads=2, ssm_state=8, ssm_chunk=chunk), 7)
    x = torch.from_numpy(normal(seed, (1, L, 32), 0.3))
    y1 = tssm.mamba2_forward(p, cfg, x)
    y2 = tssm.mamba2_forward(p, cfg.replace(ssm_chunk=L), x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=3e-4, rtol=3e-3)


MOE_KW = dict(family="moe", d_model=16, n_experts=4, n_experts_per_tok=2,
              moe_d_ff=8, capacity_factor=8.0, vocab=32, norm_topk_prob=True,
              moe_group_size=8)


def dense_mix(p, x: np.ndarray, topi, topw, keep) -> np.ndarray:
    """Each token's kept expert choices, weighted, computed one by one."""
    silu = lambda a: a / (1.0 + np.exp(-a))
    P = {k: np.asarray(v, np.float64) for k, v in p.items() if k != "shared"}
    y = np.zeros_like(x, dtype=np.float64)
    for t in range(x.shape[0]):
        for j in range(topi.shape[1]):
            if keep[t, j]:
                e = int(topi[t, j])
                h = silu(x[t] @ P["wg"][e]) * (x[t] @ P["wu"][e])
                y[t] += float(topw[t, j]) * (h @ P["wd"][e])
    return y


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_moe_fullcapacity_matches_dense(seed):
    """With ample capacity the grouped MoE equals the per-token dense mix."""
    _, _, cfg, p = block_pair(jmoe.moe_specs, MOE_KW, 11)
    x = torch.from_numpy(normal(seed, (2, 8, 16)))
    y = tmoe.moe_ffn(p, cfg, x)
    xf = x.reshape(-1, 16)
    topi, topw = tmoe.router_topk(xf @ p["router"], 2, True)
    keep = np.ones(topi.shape, bool)
    np.testing.assert_allclose(y.reshape(16, 16).numpy(),
                               dense_mix(p, xf.numpy(), topi, topw, keep),
                               atol=1e-4, rtol=1e-3)


def fifo_keep(topi: np.ndarray, C: int, E: int) -> np.ndarray:
    """First come, first served within each expert over (token, choice) in
    order: a choice is kept iff fewer than C earlier ones chose its
    expert."""
    seen = np.zeros(E, int)
    keep = np.zeros(topi.shape, bool)
    for t in range(topi.shape[0]):
        for j in range(topi.shape[1]):
            e = topi[t, j]
            keep[t, j] = seen[e] < C
            seen[e] += 1
    return keep


@pytest.mark.parametrize("n_shared", [0, 2], ids=["qwen3", "deepseek"])
def test_moe_drops_the_reference_tokens(n_shared):
    """At the full configs' capacity factor 1.25 tokens are dropped: 2
    groups of 32 tokens, 8 experts top-2 (C = 8 a group), skewed routing.
    The port's output equals the JAX package's; its drop set is the
    FIFO-within-expert set of every group and is not empty; and the
    reference's output is the dense mix of exactly those kept choices (plus
    the shared experts), so both packages drop the same tokens."""
    kw = dict(MOE_KW, d_model=16, n_experts=8, capacity_factor=1.25,
              moe_group_size=32, n_shared_experts=n_shared,
              norm_topk_prob=n_shared == 0, d_ff=8)
    jcfg, jp, tcfg, tp = block_pair(jmoe.moe_specs, kw, 21)
    # skew the routing so that two experts take most tokens: inputs of
    # positive mean, router columns 0 and 1 raised
    router = np.array(jp["router"])
    router[:, 0] += 0.3
    router[:, 1] += 0.2
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = normal(22, (2, 32, 16)) + 1.0
    want = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    got = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x))
    assert_close(got, want, TOL, "moe_ffn")

    G, gs, k, E = 2, 32, 2, 8
    assert tmoe.n_groups(G * gs, 32) == G
    C = tmoe.capacity(gs, k, E, 1.25)
    assert C == 16 // 8 * 8 and C == jmoe.capacity(gs, k, E, 1.25)
    xg = torch.from_numpy(x).reshape(G, gs, 16)
    topi, topw = tmoe.router_topk(xg @ tp["router"], k, tcfg.norm_topk_prob)
    _, slot_by_token = tmoe.dispatch(topi, E, C)
    kept = (slot_by_token < E * C).numpy()
    keep = np.stack([fifo_keep(topi[g].numpy(), C, E) for g in range(G)])
    assert np.array_equal(kept, keep)
    assert (~kept).sum() > 0
    jtopi, jtopw = jmoe.router_topk(jnp.asarray(x).reshape(G, gs, 16)
                                    @ jp["router"], k, jcfg.norm_topk_prob)
    assert np.array_equal(np.asarray(jtopi), topi.numpy())
    ref = np.stack([dense_mix(jp, x.reshape(G, gs, 16)[g], np.asarray(jtopi[g]),
                              np.asarray(jtopw[g]), keep[g]) for g in range(G)])
    if n_shared:
        from repro.models.layers import mlp as jmlp
        ref = ref + np.asarray(jmlp(jp["shared"], jcfg,
                                    jnp.asarray(x))).reshape(G, gs, 16)
    np.testing.assert_allclose(np.asarray(want).reshape(G, gs, 16), ref,
                               atol=1e-4, rtol=1e-3)


def test_router_topk_breaks_ties_as_lax_top_k():
    """Equal router probabilities: the lower expert first (lax.top_k)."""
    logits = np.array([[0.0, 1.0, 1.0, 0.5, 1.0]], np.float32)
    ti, tw = tmoe.router_topk(torch.from_numpy(logits), 3, False)
    ji, jw = jmoe.router_topk(jnp.asarray(logits), 3, False)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 2, 4]]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)


@pytest.mark.parametrize("T,group", [(8, 4096), (4096, 4096), (640, 64),
                                     (96, 7), (3, 2), (1 << 20, 4096)])
def test_dispatch_sizes_match_reference(T, group):
    assert tmoe.n_groups(T, group) == jmoe.n_groups(T, group)
    for k, E, f in ((8, 128, 1.25), (6, 160, 1.25), (2, 8, 8.0)):
        assert tmoe.capacity(T, k, E, f) == jmoe.capacity(T, k, E, f)


# ---------------------------------------------------- configs and specs ----
@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_specs_and_caches_match_reference(arch):
    """Full configs are copies; the reduced twins, parameter counts (full
    and reduced), parameter paths and shapes, cache specs (shapes, dtypes)
    and batch axes equal the JAX package's."""
    full = tconfigs.get_config(arch)
    jfull = jconfigs.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert tapi.n_params(full) == japi.n_params(jfull)
    for jcfg, tcfg in ((jconfigs.reduced_config(arch),
                        tconfigs.reduced_config(arch)), (jfull, full)):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tapi.n_params(tcfg) == japi.n_params(jcfg)
        jshapes = {".".join(str(k.key) for k in path): tuple(s.shape)
                   for path, s in jax.tree_util.tree_leaves_with_path(
                       japi.specs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))}
        assert tapi.param_shapes(tcfg) == jshapes
        is_leaf = lambda x: isinstance(x, tuple) and len(x) == 2 and hasattr(
            x[0], "shape")
        jc = {".".join(str(k.key) for k in path): (tuple(t[0].shape),
                                                   str(t[0].dtype), t[1])
              for path, t in jax.tree_util.tree_leaves_with_path(
                  japi.cache_specs(jcfg, 3, 20), is_leaf=is_leaf)}
        tc = {path: (tuple(shape), str(dt).removeprefix("torch."), axes)
              for path, (shape, dt, axes) in tree_leaves(
                  tapi.cache_specs(tcfg, 3, 20))}
        assert tc == jc
        assert tapi.cache_batch_axes(tcfg, 3, 20) == japi.cache_batch_axes(
            jcfg, 3, 20)
    cache = tapi.init_cache(tconfigs.reduced_config(arch), 3, 20, device="cpu")
    assert not any(t.any() for _, t in tree_leaves(cache))


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_layout(arch):
    """``init_params`` draws every leaf of the spec tree (the hybrid's
    shared blocks included) under its JAX path, and the same seed gives the
    same weights."""
    cfg = tconfigs.reduced_config(arch)
    m = tapi.init_params(cfg, seed=3, device="cpu")
    sd = m.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == tapi.param_shapes(cfg)
    again = tapi.init_params(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    if cfg.family == "hybrid":
        stages, shared = m._layers
        assert len(shared) == cfg.n_shared_blocks
        assert shared[1]["attn"]["wq"].data_ptr() == \
            m.tree()["shared"]["attn"]["wq"][1].data_ptr()


def test_converter_refuses_a_misshapen_nested_leaf():
    jcfg, jp, tcfg, _ = pair("xlstm-1.3b", 0)
    tree = jax.tree.map(np.asarray, jp)
    tree["stage_0"]["mlstm"]["w_q"] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="stage_0.mlstm.w_q"):
        convert.params_from_numpy(tree, tcfg, "cpu")
    del tree["stage_0"]["slstm"]["r_i"]
    with pytest.raises(KeyError, match="stage_0.slstm.r_i"):
        convert.params_from_numpy(tree, tcfg, "cpu")


@pytest.mark.parametrize("arch", ["paligemma-3b", "seamless-m4t-medium"])
def test_vlm_and_encdec_configs_match_reference(arch):
    """These archs were refused until their families were ported: the
    registry now returns the reference's configs,
    field for field, full and reduced, and their spec trees have the
    reference's shapes."""
    for get in ("get_config", "reduced_config"):
        tcfg = getattr(tconfigs, get)(arch)
        jcfg = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tapi.param_shapes(tcfg) == {
            ".".join(str(k.key) for k in p): tuple(s.shape)
            for p, s in jax.tree_util.tree_leaves_with_path(
                japi.specs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))}
    assert arch in tconfigs.ARCHS


def test_mla_flash_is_refused_before_any_kernel():
    """The dispatch refuses a v head dim other than q's before it looks at
    the device (the kernel takes one head dim), so MLA with ``use_flash``
    never reaches the kernel."""
    q = torch.zeros(1, 4, 2, 48)
    v = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="v head dim 32 differs"):
        ops.flash_attention(q, q, v)
