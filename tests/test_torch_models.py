"""The port's dense transformer against the JAX package's, on the same
converted parameters (``convert.params_from_numpy``): reduced
``smollm-135m`` (GQA 4 over 2) and reduced ``qwen1.5-0.5b`` (QKV bias,
G = 1), 2 layers, prefill logits and KV caches, then 4 decode steps, with
the flash path on and off.

Tolerances: float32 to 1e-4 (matmul sums run in another order in XLA:CPU
and PyTorch; observed ~1e-6); bfloat16 to 5e-2 of the largest logit (both
round activations to bf16 after every op, and a one-ulp difference, 2**-8
relative, can flip at any of them and carry through the 2 layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttfm
from repro_torch.models.common import ModelConfig

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_REL_TOL = 5e-2


def pair(arch: str, seed: int, **kw):
    """(jax cfg, jax params, port cfg, port params) on the same weights;
    biases get random values so that their path is exercised."""
    jcfg = jconfigs.reduced_config(arch).replace(**kw)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    jp = japi.init_params(jcfg, jax.random.key(seed))
    r = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.array(a.astype(jnp.float32)), jp)
    for name in ("bq", "bk", "bv"):
        if name in tree["stage_0"]["attn"]:
            b = tree["stage_0"]["attn"][name]
            tree["stage_0"]["attn"][name] = (0.1 * r.normal(size=b.shape)
                                             ).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jcfg.pdtype), tree)
    return jcfg, jp, tcfg, convert.params_from_numpy(tree, tcfg, "cpu")


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def assert_close(got, want, dtype):
    got, want = as_np(got), as_np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL_TOL * np.abs(want).max()


CASES = [(arch, flash, "float32") for arch in ("smollm-135m", "qwen1.5-0.5b")
         for flash in (False, True)] + [("smollm-135m", True, "bfloat16")]


@pytest.mark.parametrize("arch,flash,dtype", CASES)
def test_prefill_and_decode_match_reference(arch, flash, dtype):
    jcfg, jp, tcfg, tp = pair(arch, 0, use_flash=flash, param_dtype=dtype,
                              compute_dtype=dtype)
    B, P, max_len = 3, 16, 21
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    jl, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, max_len)
    assert tl.shape == (B, 1, jcfg.vocab) and tl.dtype == tcfg.cdtype
    assert_close(tl, jl, dtype)
    for name in ("k", "v"):
        assert tc["stage_0"][name].shape == jc["stage_0"][name].shape
        assert_close(tc["stage_0"][name], jc["stage_0"][name], dtype)
    r = np.random.default_rng(2)
    for s in range(4):
        tok = r.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = japi.decode(jp, jcfg, jnp.asarray(tok), P + s, jc)
        tl, tc = tapi.decode(tp, tcfg, torch.from_numpy(tok), P + s, tc)
        assert_close(tl, jl, dtype)
    for name in ("k", "v"):
        assert_close(tc["stage_0"][name], jc["stage_0"][name], dtype)


def test_decode_at_per_row_positions_matches_reference():
    """Every row at its own position (the JAX package's per-slot cache
    write), and an out-of-range position is refused, not clamped."""
    jcfg, jp, tcfg, tp = pair("smollm-135m", 1)
    B, P, max_len = 3, 8, 12
    toks = np.random.default_rng(4).integers(0, 512, (B, P)).astype(np.int32)
    _, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len)
    _, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, max_len)
    pos = np.array([8, 10, 11], np.int32)
    tok = np.array([[1], [2], [3]], np.int32)
    jl, jc = japi.decode(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc)
    tl, tc = tapi.decode(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos), tc)
    assert_close(tl, jl, "float32")
    assert_close(tc["stage_0"]["k"], jc["stage_0"]["k"], "float32")
    with pytest.raises(IndexError):
        tapi.decode(tp, tcfg, torch.from_numpy(tok), max_len, tc)


def test_hidden_states_match_reference():
    jcfg, jp, tcfg, tp = pair("qwen1.5-0.5b", 2, use_flash=True)
    toks = np.random.default_rng(5).integers(0, 512, (2, 12)).astype(np.int32)
    want, _ = jtfm.lm_hidden(jp, jcfg, jnp.asarray(toks))
    got = ttfm.lm_hidden(tp, tcfg, torch.from_numpy(toks))
    assert_close(got, want, "float32")


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen1.5-0.5b", "qwen1.5-4b",
                                  "llama3-8b"])
def test_configs_specs_and_caches_match_reference(arch):
    """Full configs are copies; reduced twins, parameter counts, parameter
    paths and shapes, and cache shapes equal the JAX package's."""
    full = tconfigs.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jconfigs.get_config(arch))
    jcfg = jconfigs.reduced_config(arch)
    tcfg = tconfigs.reduced_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tapi.n_params(full) == japi.n_params(jconfigs.get_config(arch))
    jshapes = {".".join(str(k.key) for k in path): tuple(s.shape)
               for path, s in jax.tree_util.tree_leaves_with_path(
                   japi.specs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))}
    assert tapi.param_shapes(tcfg) == jshapes
    jcache = japi.cache_specs(jcfg, 3, 20)
    tcache = tapi.cache_specs(tcfg, 3, 20)
    for name in ("k", "v"):
        assert tcache["stage_0"][name][0] == jcache["stage_0"][name][0].shape
    assert tapi.cache_batch_axes(tcfg, 3, 20) == japi.cache_batch_axes(jcfg, 3, 20)
    cache = tapi.init_cache(tcfg, 3, 20, device="cpu")
    assert cache["stage_0"]["k"].shape == jcache["stage_0"]["k"][0].shape
    assert not cache["stage_0"]["k"].any()


def test_init_params_module_layout_and_scales():
    """state_dict keys are the JAX tree paths; weights follow the specs'
    scales (truncated normal: std ~0.88 x scale), the final norm is ones,
    biases zeros; the same seed gives the same weights. As in the JAX
    package's ``init_tree``, only a 1-D scale-1 leaf is ones: the
    layer-stacked norm weights (L, d) are drawn like any scale-1 leaf."""
    cfg = tconfigs.reduced_config("qwen1.5-0.5b").replace(n_layers=3)
    m = tapi.init_params(cfg, seed=7, device="cpu")
    sd = m.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == tapi.param_shapes(cfg)
    assert m.tree()["stage_0"]["attn"]["wq"] is m.stage_0.attn.wq
    assert not any(p.requires_grad for p in m.parameters())
    wq = sd["stage_0.attn.wq"]
    assert abs(float(wq.std()) / (0.88 / cfg.d_model ** 0.5) - 1) < 0.1
    assert float(wq.abs().max()) <= 2 / cfg.d_model ** 0.5 + 1e-6
    assert torch.equal(sd["final_norm"], torch.ones(cfg.d_model))
    assert abs(float(sd["stage_0.ln1"].std()) / 0.88 - 1) < 0.1
    assert not sd["stage_0.attn.bq"].any()
    again = tapi.init_params(cfg, seed=7, device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert sd["embed.embedding"].dtype == torch.float32


def test_converter_refuses_missing_unknown_and_misshapen_leaves():
    jcfg, jp, tcfg, _ = pair("smollm-135m", 0)
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, extra={"w": np.zeros(3)})
    with pytest.raises(KeyError, match="unknown"):
        convert.params_from_numpy(bad, tcfg, "cpu")
    short = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="missing"):
        convert.params_from_numpy(short, tcfg, "cpu")
    wrong = dict(tree, final_norm=np.ones(7, np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy(wrong, tcfg, "cpu")
    with pytest.raises(KeyError, match="unknown"):
        convert.model_config_from_dict({**dataclasses.asdict(tcfg), "x": 1})
    assert isinstance(convert.model_config_from_dict(dataclasses.asdict(tcfg)),
                      ModelConfig)
