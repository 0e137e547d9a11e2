"""The port's vlm (PaliGemma) and encoder-decoder (SeamlessM4T) families
against the JAX package's, on the same converted parameters
(``convert.params_from_numpy``) and inputs drawn from numpy seeds: the
reduced twins of ``paligemma-3b`` (2 layers, MQA at head dim 32, tanh gelu,
8 patches of width 48) and ``seamless-m4t-medium`` (2 encoder and 2 decoder
layers, frames of width 48), float32, and the building blocks they add:
``layernorm``, ``sinusoidal_pos``, the prefix-LM mask, the q-chunked
``sdpa_chunked``, ``run_attention``'s dispatch order, cross-attention, the
encoder-decoder's blocks, specs and caches, and the searches with
``batch_extras``.

Tolerance: every float32 value within ``TOL`` (1e-5) times the largest
magnitude of the reference's (float32 sums run in another order in XLA:CPU
and PyTorch; observed ~5e-7 on these twins); integer results and trees
exactly equal, token-tree wins to ``WINS_RTOL``. The bf16 case holds the
vlm's embedded inputs (gemma's embed scale rounded to bf16 before the
multiply) bit for bit.
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
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models import vlm as jvlm
from repro.models.common import ModelConfig as JModelConfig
from repro.models.common import init_tree as jinit_tree
from repro.models.common import spec_with_dtype as jspec_with_dtype
from repro.serve import mcts_decode as jmd
from repro_torch import configs as tconfigs
from repro_torch import convert, rng
from repro_torch.core import tree as tt
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models import vlm as tvlm
from repro_torch.models.common import tree_leaves
from repro_torch.serve import mcts_decode as tmd
from torch_parity_util import assert_same_decode_search, decode_tree_parts

torch.set_num_threads(1)

TOL = 1e-5
VLM, ENCDEC = "paligemma-3b", "seamless-m4t-medium"


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


def assert_same_cache(tc, jc, what, tol=TOL):
    want, got = jax_leaves(jc), dict(tree_leaves(tc))
    assert set(got) == set(want), what
    for name in want:
        assert str(got[name].dtype) == f"torch.{want[name].dtype}", (what, name)
        assert_close(got[name], want[name], tol, f"{what} {name}")


def normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def extras_for(jcfg, seed: int, B: int, S_src: int = 6) -> dict:
    """The family's stub-frontend input for B rows (numpy)."""
    if jcfg.family == "vlm":
        return {"patches": normal(seed, (B, jcfg.n_patches, jcfg.vision_width))}
    return {"frames": normal(seed, (B, S_src, jcfg.vision_width))}


def both(x: dict):
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


def shapes(spec_tree, leaf=lambda s: tuple(s.shape)) -> dict:
    """Dotted path -> shape of a JAX Spec tree."""
    from repro.models.common import Spec
    flat = jax.tree_util.tree_leaves_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, Spec))
    return {".".join(str(k.key) for k in p): leaf(s) for p, s in flat}


# ------------------------------------------------------------ layers ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    x, w, b = normal(0, (3, 5, 64), 3.0), normal(1, (64,)) + 1, normal(2, (64,))
    jd = jnp.dtype(dtype)
    want = jlayers.layernorm(*(jnp.asarray(a).astype(jd) for a in (x, w, b)),
                             1e-5)
    td = getattr(torch, dtype)
    got = tlayers.layernorm(*(torch.from_numpy(a).to(td) for a in (x, w, b)),
                            1e-5)
    assert got.dtype == td
    if dtype == "float32":
        assert_close(got, want, TOL, "layernorm")
    else:   # the same float32 statistics, one bf16 rounding each side
        assert np.array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("d", [16, 64, 1024])
def test_sinusoidal_pos_matches_reference(d):
    """XLA:CPU's and PyTorch's float32 ``exp`` part by one ulp on some of
    the frequencies (each <= 1), so an angle pos·f parts by up to
    pos·2^-23: held to TOL plus that, in absolute terms (values in [-1,
    1])."""
    pos = np.arange(0, 300, 7, dtype=np.int32)
    want = jlayers.sinusoidal_pos(jnp.asarray(pos), d)
    got = tlayers.sinusoidal_pos(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (len(pos), d)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= TOL + int(pos.max()) * 2.0 ** -23, err


# ------------------------------------------------------------- masks ----
@pytest.mark.parametrize("S,prefix", [(1, 0), (8, 0), (8, 3), (16, 16),
                                      (20, 9), (5, 8)])
def test_prefix_lm_mask_matches_reference(S, prefix):
    want = np.asarray(jattn.prefix_lm_mask(S, prefix))
    got = tattn.prefix_lm_mask(S, prefix).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)


# ------------------------------------------------------ sdpa_chunked ----
def qkv(seed, B=2, S=64, H=4, Hkv=2, d=16):
    return (normal(seed, (B, S, H, d)), normal(seed + 1, (B, S, Hkv, d)),
            normal(seed + 2, (B, S, Hkv, d)))


@pytest.mark.parametrize("chunk,prefix", [(8, 0), (16, 0), (32, 0), (16, 10),
                                          (8, 21), (16, 64)],
                         ids=["c8", "c16", "c32", "c16-prefix10",
                              "c8-prefix21-spans-3-chunks", "c16-all-prefix"])
def test_sdpa_chunked_matches_full(chunk, prefix):
    """After tests/test_models_consistency.py::test_sdpa_chunked_matches_full:
    each chunk's mask built from positions equals the full mask's rows —
    against the port's own ``sdpa`` under the full mask (that test's
    tolerance) and against the JAX package's ``sdpa_chunked``."""
    q, k, v = qkv(0)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    full = tattn.sdpa(tq, tk, tv, tattn.prefix_lm_mask(64, prefix))
    got = tattn.sdpa_chunked(tq, tk, tv, chunk, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5, rtol=2e-5)
    want = jattn.sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)), chunk,
                              prefix_len=prefix)
    assert_close(got, want, TOL, "sdpa_chunked")
    with pytest.raises(ValueError, match="not a multiple"):
        tattn.sdpa_chunked(tq[:, :63], tk[:, :63], tv[:, :63], chunk)


# ---------------------------------------------------- run_attention ----
DISPATCH = [  # (use_flash, attn_chunk, prefix_len, S) -> path
    (True, 0, 0, 32, "flash"),
    (True, 8, 0, 32, "flash"),        # flash before the chunked path
    (True, 8, 5, 32, "chunked"),      # a prefix never goes to flash
    (True, 0, 5, 32, "sdpa"),
    (False, 8, 0, 32, "chunked"),
    (False, 8, 11, 32, "chunked"),
    (False, 32, 0, 32, "sdpa"),       # S == chunk: one chunk is sdpa
    (False, 8, 0, 30, "sdpa"),        # S not a multiple of the chunk
    (False, 0, 5, 32, "sdpa"),
    (False, 0, 0, 32, "sdpa"),
]


@pytest.mark.parametrize("flash,chunk,prefix,S,path", DISPATCH)
def test_run_attention_follows_the_reference_order(flash, chunk, prefix, S,
                                                   path, monkeypatch):
    """The reference's order: flash only with ``use_flash`` and no prefix,
    then the q-chunked path when the chunk splits S, then ``sdpa`` under
    the causal or prefix-LM mask; and the output equals the reference's
    (its flash in Pallas interpret mode)."""
    cfg = JModelConfig(use_flash=flash, attn_chunk=chunk)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(cfg))
    q, k, v = qkv(3, S=S)
    called = []
    real_flash, real_chunked = ops.flash_attention, tattn.sdpa_chunked
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: (
        called.append("flash"), real_flash(*a, **kw))[1])
    monkeypatch.setattr(tattn, "sdpa_chunked", lambda *a, **kw: (
        called.append("chunked"), real_chunked(*a, **kw))[1])
    got = tattn.run_attention(tcfg, *(torch.from_numpy(a) for a in (q, k, v)),
                              prefix_len=prefix)
    assert called == ([] if path == "sdpa" else [path])
    want = jattn.run_attention(cfg, *(jnp.asarray(a) for a in (q, k, v)),
                               prefix_len=prefix)
    assert_close(got, want, TOL, "run_attention")


# ----------------------------------------------- attention blocks ----
def block_pair(spec_fn, cfg: JModelConfig, seed: int):
    tcfg = convert.model_config_from_dict(dataclasses.asdict(cfg))
    jp = jinit_tree(jspec_with_dtype(spec_fn(cfg), jnp.float32),
                    jax.random.key(seed))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tcfg, tp


ATTN_CFG = JModelConfig(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16)


@pytest.mark.parametrize("prefix", [3, 12])
def test_prefix_attention_and_prefill_match_reference(prefix):
    """``gqa_prefix_attention`` and ``gqa_prefill(..., prefix_len=)`` (MQA,
    the paligemma layout), against the reference's; the prefill's K/V too."""
    jp, tcfg, tp = block_pair(jattn.gqa_specs, ATTN_CFG, 0)
    x = normal(1, (2, 12, 64))
    want = jattn.gqa_prefix_attention(jp, ATTN_CFG, jnp.asarray(x), prefix)
    got = tattn.gqa_prefix_attention(tp, tcfg, torch.from_numpy(x), prefix)
    assert_close(got, want, TOL, "gqa_prefix_attention")
    (jo, (jk, jv)) = jattn.gqa_prefill(jp, ATTN_CFG, jnp.asarray(x),
                                       prefix_len=prefix)
    (to, (tk, tv)) = tattn.gqa_prefill(tp, tcfg, torch.from_numpy(x),
                                       prefix_len=prefix)
    for what, a, b in (("out", to, jo), ("k", tk, jk), ("v", tv, jv)):
        assert_close(a, b, TOL, f"gqa_prefill {what}")


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_matches_reference(masked):
    """No RoPE, scale 1/sqrt(hd), every query head over its own memory head;
    ``cross_specs`` has the reference's shapes."""
    cfg = JModelConfig(d_model=64, n_heads=4, n_kv_heads=4)
    assert {p: tuple(s.shape) for p, s in
            tree_leaves(tattn.cross_specs(
                convert.model_config_from_dict(dataclasses.asdict(cfg))))} \
        == shapes(jattn.cross_specs(cfg))
    jp, tcfg, tp = block_pair(jattn.cross_specs, cfg, 2)
    x, mem = normal(3, (2, 5, 64)), normal(4, (2, 9, 64))
    mask = (np.random.default_rng(5).random((2, 9)) < 0.6) if masked else None
    if masked:
        mask[:, 0] = True
    want = jattn.cross_attention(jp, cfg, jnp.asarray(x), jnp.asarray(mem),
                                 None if mask is None else jnp.asarray(mask))
    got = tattn.cross_attention(tp, tcfg, torch.from_numpy(x),
                                torch.from_numpy(mem),
                                None if mask is None else torch.from_numpy(mask))
    assert_close(got, want, TOL, "cross_attention")


# ------------------------------------------------------- encdec blocks ----
def layer0(jtree, ttree, stack: str):
    """Layer 0 of a stacked stack in both packages."""
    return (jax.tree.map(lambda a: a[0], jtree[stack]),
            {k: v for k, v in ttfm.unstack(ttree[stack],
                                           ttree[stack]["ln1"].shape[0])[0]
             .items()})


def test_encdec_blocks_match_reference():
    """``enc_block_fwd``, ``dec_block_fwd``, ``_cross_kv``, ``_cross_apply``,
    ``dec_block_prefill`` (its cache: padded self K/V and the cross K/V)
    and two ``dec_block_decode`` steps, on layer 0 of the reduced twin;
    the block specs have the reference's shapes."""
    jcfg, jp, tcfg, tp = pair(ENCDEC, 0)
    for jfn, tfn in ((jed.enc_block_specs, ted.enc_block_specs),
                     (jed.dec_block_specs, ted.dec_block_specs)):
        assert {p: tuple(s.shape) for p, s in tree_leaves(tfn(tcfg))} \
            == shapes(jfn(jcfg))
    tree = tp.tree()
    je, te = layer0(jp, tree, "enc")
    jdl, tdl = layer0(jp, tree, "dec")
    x, mem = normal(1, (2, 7, 128)), normal(2, (2, 5, 128))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jm, tm = jnp.asarray(mem), torch.from_numpy(mem)
    assert_close(ted.enc_block_fwd(te, tcfg, tx),
                 jed.enc_block_fwd(je, jcfg, jx), TOL, "enc_block_fwd")
    assert_close(ted.dec_block_fwd(tdl, tcfg, tx, tm),
                 jed.dec_block_fwd(jdl, jcfg, jx, jm), TOL, "dec_block_fwd")
    jk, jv = jed._cross_kv(jdl["xattn"], jm)
    tk, tv = ted._cross_kv(tdl["xattn"], tm)
    assert_close(tk, jk, TOL, "_cross_kv k")
    assert_close(tv, jv, TOL, "_cross_kv v")
    assert_close(ted._cross_apply(tdl["xattn"], tx, tk, tv),
                 jed._cross_apply(jdl["xattn"], jx, jk, jv), TOL,
                 "_cross_apply")
    jy, jc = jed.dec_block_prefill(jdl, jcfg, jx, jm, 10)
    ty, tc = ted.dec_block_prefill(tdl, tcfg, tx, tm, 10)
    assert_close(ty, jy, TOL, "dec_block_prefill")
    assert_same_cache(tc, jc, "dec_block_prefill cache")
    for s in range(2):
        step = normal(3 + s, (2, 1, 128))
        jy, jc = jed.dec_block_decode(jdl, jcfg, jnp.asarray(step), jc, 7 + s)
        ty, tc = ted.dec_block_decode(tdl, tcfg, torch.from_numpy(step), tc,
                                      7 + s)
        assert_close(ty, jy, TOL, f"dec_block_decode {s}")
    assert_same_cache(tc, jc, "dec_block_decode cache")


def test_encoder_and_decoder_hidden_match_reference():
    jcfg, jp, tcfg, tp = pair(ENCDEC, 1)
    frames, toks = normal(4, (2, 9, 48)), tokens(5, (2, 6))
    assert_close(ted.encode(tp, tcfg, torch.from_numpy(frames)),
                 jed.encode(jp, jcfg, jnp.asarray(frames)), TOL, "encode")
    assert_close(
        ted.encdec_hidden(tp, tcfg, torch.from_numpy(frames),
                          torch.from_numpy(toks)),
        jed.encdec_hidden(jp, jcfg, jnp.asarray(frames), jnp.asarray(toks)),
        TOL, "encdec_hidden")


# ------------------------------------------------ specs and caches ----
@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_specs_and_cache_trees_match_reference(arch):
    """``api.specs`` (the vlm's ``vision_proj``; the encdec tree), every
    leaf's shape and init scale, ``cache_specs`` (shapes, dtypes, axes;
    the encdec ``src_len`` defaulting to min(ENCDEC_SRC_LEN, max_len)),
    ``cache_batch_axes``, ``init_cache`` and ``param_shapes``."""
    assert tapi.ENCDEC_SRC_LEN == japi.ENCDEC_SRC_LEN
    for full in (False, True):
        jcfg = (jconfigs.get_config if full else jconfigs.reduced_config)(arch)
        tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
        want = shapes(japi.specs(jcfg), lambda s: (tuple(s.shape), s.scale))
        got = {p: (tuple(s.shape), s.scale)
               for p, s in tree_leaves(tapi.specs(tcfg))}
        assert got == want
        assert tapi.param_shapes(tcfg) == {p: s for p, (s, _) in want.items()}
        assert tapi.n_params(tcfg) == japi.n_params(jcfg)
        for max_len, src_len in ((24, None), (8000, None), (24, 5)):
            jspec = japi.cache_specs(jcfg, 3, max_len, src_len)
            is_leaf = lambda x: (isinstance(x, tuple) and len(x) == 2
                                 and hasattr(x[0], "shape"))
            flat = jax.tree_util.tree_leaves_with_path(jspec, is_leaf=is_leaf)
            want_c = {".".join(str(k.key) for k in p): (
                tuple(t[0].shape), str(t[0].dtype), tuple(t[1]))
                for p, t in flat}
            got_c = {p: (tuple(t[0]), str(t[1]).removeprefix("torch."),
                         tuple(t[2]))
                     for p, t in tree_leaves(tapi.cache_specs(
                         tcfg, 3, max_len, src_len))}
            assert got_c == want_c
            assert dict(tree_leaves(tapi.cache_batch_axes(
                tcfg, 3, max_len, src_len))) == jax_leaves(
                japi.cache_batch_axes(jcfg, 3, max_len, src_len))
    cache = tapi.init_cache(tcfg, 2, 16, device="cpu")
    jcache = japi.init_cache(jcfg, 2, 16)
    assert {p: (tuple(t.shape), str(t.dtype)) for p, t in tree_leaves(cache)} \
        == {p: (tuple(t.shape), f"torch.{t.dtype}")
            for p, t in jax_leaves(jcache).items()}
    assert all(not t.any() for _, t in tree_leaves(cache))


# --------------------------------------------------------------- vlm ----
def test_vlm_stub_helpers_match_reference():
    """``patch_spec`` (shape and dtype), ``text_len`` (and its refusal of a
    sequence with no text), ``fake_patches`` (its shape, dtype, scale and
    seed)."""
    for full in (False, True):
        jcfg = (jconfigs.get_config if full else jconfigs.reduced_config)(VLM)
        tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
        js = jvlm.patch_spec(jcfg, 3)
        shape, dtype = tvlm.patch_spec(tcfg, 3)
        assert shape == js.shape and str(dtype) == f"torch.{js.dtype}"
        for S in (jcfg.n_patches + 1, jcfg.n_patches + 64):
            assert tvlm.text_len(tcfg, S) == jvlm.text_len(jcfg, S)
        with pytest.raises(AssertionError):
            jvlm.text_len(jcfg, jcfg.n_patches)
        with pytest.raises(ValueError, match="no text"):
            tvlm.text_len(tcfg, jcfg.n_patches)
    tcfg = tconfigs.reduced_config(VLM)
    g = lambda: torch.Generator().manual_seed(3)
    a, b = tvlm.fake_patches(tcfg, 4, g()), tvlm.fake_patches(tcfg, 4, g())
    want = jvlm.fake_patches(jconfigs.reduced_config(VLM), 4, jax.random.key(3))
    assert a.shape == want.shape and torch.equal(a, b)
    assert str(a.dtype) == f"torch.{want.dtype}"
    assert 0.015 < float(a.std()) < 0.025
    assert 0.015 < float(jnp.std(want)) < 0.025


def test_vlm_hidden_matches_reference():
    """``lm_hidden(..., patches=)``: [vision_proj(patches) | scaled text
    embeddings] through prefix-LM attention."""
    jcfg, jp, tcfg, tp = pair(VLM, 2)
    toks, patches = tokens(6, (2, 5)), normal(7, (2, 8, 48))
    want, prefix_len = jtfm.lm_hidden(jp, jcfg, jnp.asarray(toks),
                                      jnp.asarray(patches))
    got = ttfm.lm_hidden(tp, tcfg, torch.from_numpy(toks),
                         torch.from_numpy(patches))
    assert prefix_len == 8
    assert_close(got, want, TOL, "lm_hidden")
    with pytest.raises(ValueError, match="patches"):
        ttfm.lm_hidden(tp, tcfg, torch.from_numpy(toks))


def test_vlm_bf16_embed_scale_matches_reference():
    """gemma's embed scale is rounded to the activations' dtype before the
    multiply (45.25 in bf16 at d = 2048, not 45.2548): the port's embedded
    [vis | text] input equals the reference's bit for bit in bf16 at
    paligemma's width, and multiplying by the unrounded scale would not."""
    jcfg = jconfigs.get_config(VLM).replace(vocab=64, n_layers=1)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    assert ttfm.embed_scale(tcfg, torch.bfloat16) == 45.25
    emb = normal(8, (64, 2048), 0.5)
    proj = normal(9, (48, 2048), 0.05)
    toks, patches = tokens(10, (2, 5)) % 64, normal(11, (2, 3, 48))
    jparams = {"embed": {"embedding": jnp.asarray(emb, jnp.bfloat16)},
               "vision_proj": jnp.asarray(proj, jnp.bfloat16)}
    # the reference's lines (src/repro/models/transformer.py, lm_prefill)
    x = jlayers.embed(jparams["embed"], jnp.asarray(toks), jcfg)
    x = x * jnp.asarray(jcfg.d_model ** 0.5, x.dtype)
    vis = (jnp.asarray(patches).astype(jcfg.cdtype)
           @ jparams["vision_proj"].astype(jcfg.cdtype))
    want = as_np(jnp.concatenate([vis, x], axis=1))
    tparams = {"embed": {"embedding": torch.from_numpy(emb).bfloat16()},
               "vision_proj": torch.from_numpy(proj).bfloat16()}
    got, prefix_len = ttfm._embed_prefix(tparams, tcfg, torch.from_numpy(toks),
                                         torch.from_numpy(patches))
    assert got.dtype == torch.bfloat16 and prefix_len == 3
    assert np.array_equal(as_np(got), want)
    text = tlayers.embed(tparams["embed"], torch.from_numpy(toks), tcfg)
    assert not torch.equal(text * 2048 ** 0.5, got[:, 3:])


# ---------------------------------------------------- whole models ----
@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
@pytest.mark.parametrize("arch,chunk", [(VLM, 0), (VLM, 4), (ENCDEC, 0),
                                        (ENCDEC, 4)],
                         ids=["vlm", "vlm-chunked", "encdec",
                              "encdec-chunked"])
def test_prefill_cache_and_decode_match_reference(arch, chunk, flash):
    """Prefill logits, every cache leaf and 4 decode steps' logits and
    caches, float32 to TOL. With ``use_flash`` the JAX side runs its Pallas
    kernel in interpret mode where it runs: the encdec decoder's prefill,
    never the vlm's prefix-LM prefill. With ``attn_chunk`` 4 the vlm's
    8-patch prefix spans two chunks."""
    jcfg, jp, tcfg, tp = pair(arch, 3, use_flash=flash, attn_chunk=chunk)
    B, P = 3, 8
    toks = tokens(12, (B, P))
    ex = extras_for(jcfg, 13, B)
    S = P + (jcfg.n_patches if arch == VLM else 0)
    max_len = S + 5
    jex, tex = both(ex)
    jl, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks), **jex},
                          max_len)
    tl, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks), **tex},
                          max_len)
    assert tl.shape == (B, 1, jcfg.vocab) and tl.dtype == torch.float32
    assert_close(tl, jl, TOL, "prefill logits")
    assert_same_cache(tc, jc, "prefill cache")
    for s in range(4):
        tok = tokens(14 + s, (B, 1))
        jl, jc = japi.decode(jp, jcfg, jnp.asarray(tok), S + s, jc)
        tl, tc = tapi.decode(tp, tcfg, torch.from_numpy(tok), S + s, tc)
        assert_close(tl, jl, TOL, f"decode {s} logits")
    assert_same_cache(tc, jc, "decode cache")


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_decode_at_per_row_positions_and_position_checks(arch):
    """Every row at its own position; positions are checked against the
    self-attention cache's length (for encdec ``k``'s, not the memory's
    S_src, which is longer here)."""
    jcfg, jp, tcfg, tp = pair(arch, 4)
    B, P, max_len = 3, 6, 16
    toks = tokens(20, (B, P))
    jex, tex = both(extras_for(jcfg, 21, B, S_src=24))
    _, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks), **jex},
                         max_len)
    _, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks), **tex},
                         max_len)
    pos = np.array([14, 15, 14], np.int32)
    tok = np.array([[1], [2], [3]], np.int32)
    jl, jc = japi.decode(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc)
    tl, tc = tapi.decode(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
                         tc)
    assert_close(tl, jl, TOL, "logits")
    assert_same_cache(tc, jc, "cache")
    with pytest.raises(IndexError):
        tapi.decode(tp, tcfg, torch.from_numpy(tok), max_len, tc)


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_prefill_inputs_are_checked(arch):
    """A prefill longer than ``max_len`` raises ``ValueError`` in both
    packages (the reference in ``_pad_len``); a missing stub input and an
    unknown batch key are refused by name."""
    jcfg, jp, tcfg, tp = pair(arch, 5)
    toks = tokens(22, (2, 6))
    jex, tex = both(extras_for(jcfg, 23, 2))
    too_short = 6 + (jcfg.n_patches if arch == VLM else 0) - 1
    with pytest.raises(ValueError):
        japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks), **jex}, too_short)
    with pytest.raises(ValueError, match="does not fit"):
        tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks), **tex},
                     too_short)
    need = "patches" if arch == VLM else "frames"
    with pytest.raises(ValueError, match=need):
        tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, 32)
    with pytest.raises(ValueError, match="audio"):
        tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks), **tex,
                                "audio": torch.zeros(1)}, 32)


def test_pad_len_pads_and_check_fits_refuses_a_longer_prefill():
    x = torch.zeros(2, 5, 3)
    assert ttfm._pad_len(x, 5) is x
    assert ttfm._pad_len(x, 7).shape == (2, 7, 3)
    assert not ttfm._pad_len(x + 1, 7)[:, 5:].any()
    ttfm.check_fits(5, 5)
    with pytest.raises(ValueError, match="does not fit"):
        ttfm.check_fits(5, 4)


def test_converter_takes_both_trees_and_refuses_a_missing_leaf():
    for arch, leaf in ((VLM, "vision_proj"), (ENCDEC, "frontend")):
        jcfg, jp, tcfg, tp = pair(arch, 6)
        sd = tp.state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            tapi.param_shapes(tcfg)
        assert leaf in sd
        tree = jax.tree.map(np.asarray, jp)
        del tree[leaf]
        with pytest.raises(KeyError, match=leaf):
            convert.params_from_numpy(tree, tcfg, "cpu")
    init = tapi.init_params(tcfg, seed=1, device="cpu")
    assert set(init.state_dict()) == set(sd)


# ------------------------------------------------------------ search ----
DKW = dict(n_playouts=24, n_tasks=6, n_workers=4, branch=4, max_depth=3,
           rollout_len=3, tree_cap=128)
# the vlm search sizes its cache by the prompt alone: the reduced twin's 8
# patches fit a 6-token prompt's cache at depth 6 and rollout 8 (20 rows)
DKW_FOR = {ENCDEC: DKW, VLM: dict(DKW, max_depth=6, rollout_len=8)}


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_decode_search_with_extras_equals_reference(arch):
    """``mcts_decode_search`` with ``batch_extras`` (one row, tiled over
    the lanes) gives the reference's tree. On the vlm twin that includes
    the reference's positions, which count the prompt only: replay writes
    from ``prompt_len``, inside the cached [patches | prompt] rows."""
    jcfg, jp, tcfg, tp = pair(arch, 7)
    prompt = np.random.default_rng(24).integers(1, 512, 6).astype(np.int32)
    tree, stats = assert_same_decode_search(
        jcfg, jp, tcfg, tp, prompt, DKW_FOR[arch], seed=4,
        extras=extras_for(jcfg, 25, 1))
    assert stats["tree_nodes"] > 1 and stats["playouts"] == 24


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_batch_search_with_extras_equals_reference(arch):
    """``mcts_decode_search_batch`` with one distinct extras row per request
    (repeated, not tiled: lane w of request b reads row b), prompts of
    lengths 6 / 4 / 5: every member's tree and best token are the
    reference's."""
    jcfg, jp, tcfg, tp = pair(arch, 8)
    prompts = np.zeros((3, 6), np.int32)
    prompts[0] = np.arange(1, 7)
    prompts[1, :4] = np.arange(2, 6)
    prompts[2, :5] = 7
    lens = np.array([6, 4, 5], np.int32)
    jex, tex = both(extras_for(jcfg, 26, 3))
    dkw = DKW_FOR[arch]
    forest, stats = tmd.mcts_decode_search_batch(
        tp, tcfg, prompts, tmd.MCTSDecodeConfig(**dkw), rng.key(2, "cpu"),
        prompt_lens=lens, batch_extras=tex, device="cpu")
    jforest, jstats = jmd.mcts_decode_search_batch(
        jp, jcfg, jnp.asarray(prompts), jmd.MCTSDecodeConfig(**dkw),
        jax.random.key(2), prompt_lens=jnp.asarray(lens), batch_extras=jex)
    for b in range(3):
        assert decode_tree_parts(tt.forest_member(forest, b),
                                 jax.tree.map(lambda x: x[b], jforest)) == []
    assert stats["best_tokens"] == jstats["best_tokens"]
    assert min(stats["tree_nodes"]) > 1


def test_batch_layout_repeats_each_request_row():
    """The batched search's layout, read off its prefill's cache: row
    b·W + w holds request b's memory (``jnp.repeat(..., axis=0)``, not
    ``jnp.tile``)."""
    jcfg, jp, tcfg, tp = pair(ENCDEC, 9)
    B, W, P = 3, 4, 5
    prompts = torch.from_numpy(tokens(27, (B, P)))
    frames = torch.from_numpy(normal(28, (B, 6, 48)))
    _, cache = tmd.prefill_batch(tp, tcfg, prompts, torch.full((B,), P), W, 12,
                                 {"frames": frames})
    xk = cache["dec"]["xk"]                              # (L, B·W, S_src, H, hd)
    for b in range(B):
        mem = ted._cross_kv(
            ttfm.unstack(tp.tree()["dec"], 2)[0]["xattn"],
            ted.encode(tp, tcfg, frames[b:b + 1]))[0]
        for w in range(W):
            torch.testing.assert_close(xk[0, b * W + w], mem[0], rtol=0,
                                       atol=1e-5)
    assert not torch.equal(xk[0, 0], xk[0, W])


def test_vlm_search_refuses_a_prefix_that_does_not_fit():
    """The reference's search sizes its cache by the prompt alone
    (prompt_len + max_depth + rollout_len + 1), so a vlm prefix that does
    not fit it makes its prefill raise ``ValueError``: at paligemma-3b's
    full width (256 patches, a 64-token prompt: 320 > 79) as the JAX
    package traces it on abstract weights, and on the reduced twin with a
    short horizon. The port raises the same ``ValueError`` before any
    model work (its parameters are not even read)."""
    jcfg = jconfigs.get_config(VLM)
    tcfg = tconfigs.get_config(VLM)
    cfg = dict(n_playouts=64, n_tasks=4, n_workers=4)
    prompt = np.arange(1, 65, dtype=np.int32)
    patches = np.zeros((1, 256, 1152), np.float32)
    jpatches = jnp.asarray(patches, jnp.bfloat16)
    with pytest.raises(ValueError):
        jax.eval_shape(lambda p: jmd.mcts_decode_search(
            p, jcfg, jnp.asarray(prompt), jmd.MCTSDecodeConfig(**cfg),
            jax.random.key(0), {"patches": jpatches}), japi.abstract_params(jcfg))
    with pytest.raises(ValueError, match="320 positions .* max_len 79"):
        tmd.mcts_decode_search(
            {}, tcfg, torch.from_numpy(prompt), tmd.MCTSDecodeConfig(**cfg),
            rng.key(0, "cpu"), {"patches": torch.from_numpy(patches)},
            device="cpu")
    jcfg, jp, tcfg, tp = pair(VLM, 10)
    short = dict(DKW, max_depth=1, rollout_len=1)       # max_len = 6 + 3
    ex = extras_for(jcfg, 29, 1)
    with pytest.raises(ValueError):
        jmd.mcts_decode_search(jp, jcfg, jnp.asarray(prompt[:6]),
                               jmd.MCTSDecodeConfig(**short),
                               jax.random.key(0),
                               {"patches": jnp.asarray(ex["patches"])})
    with pytest.raises(ValueError, match="14 positions .* max_len 9"):
        tmd.mcts_decode_search(tp, tcfg, torch.from_numpy(prompt[:6]),
                               tmd.MCTSDecodeConfig(**short), rng.key(0, "cpu"),
                               {"patches": torch.from_numpy(ex["patches"])},
                               device="cpu")
