"""The port's model building blocks against the JAX package's, on the same
numpy inputs: rmsnorm in both rounding orders (against ``ref.rmsnorm``, the
Pallas kernel in interpret mode and the models' ``layers.rmsnorm``),
RoPE, the gated and plain MLPs, embedding and (tied or not) unembedding.

Tolerances: float32 to 1e-6 (elementwise math; float32 matmuls to 1e-5,
their sums run in another order), bfloat16 to 1e-2 (one bf16 step at the
values used, where XLA and PyTorch may round a float32 intermediate
differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7, 576), (2, 5, 128), (3, 97)])
def test_rmsnorm_kernel_order_matches_reference_and_pallas(shape, dtype):
    r = np.random.default_rng(sum(shape))
    xj, xt = pair(3 * r.normal(size=shape), dtype)
    wj, wt = pair(1 + 0.1 * r.normal(size=shape[-1]), "float32")
    got = tref.rmsnorm(xt, wt, 1e-5, order="kernel")
    assert got.dtype == xt.dtype and got.shape == xt.shape
    for want in (jref.rmsnorm(xj, wj, 1e-5),
                 jops.rmsnorm(xj, wj, 1e-5, interpret=True)):
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    np.testing.assert_array_equal(
        to_np(tops.rmsnorm(xt, wt, 1e-5, order="kernel")), to_np(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_rmsnorm_model_order_matches_layers_rmsnorm(dtype, wdtype):
    r = np.random.default_rng(5)
    xj, xt = pair(3 * r.normal(size=(4, 6, 576)), dtype)
    wj, wt = pair(1 + 0.1 * r.normal(size=576), wdtype)
    want = jlayers.rmsnorm(xj, wj, 1e-5)
    for got in (tref.rmsnorm(xt, wt, 1e-5, order="model"),
                tlayers.rmsnorm(xt, wt, 1e-5)):
        assert got.dtype == xt.dtype
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype])


def test_rmsnorm_orders_round_differently_in_bf16():
    """The two orders are different functions in bf16 (the reason the
    kernel takes the order as an argument), the same one in float32."""
    r = np.random.default_rng(9)
    x = torch.from_numpy(3 * r.normal(size=(64, 576)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * r.normal(size=576)).astype(np.float32))
    k32, m32 = (tref.rmsnorm(x, w, order=o) for o in ("kernel", "model"))
    assert torch.equal(k32, m32)
    kb, mb = (tref.rmsnorm(x.bfloat16(), w, order=o) for o in ("kernel", "model"))
    assert not torch.equal(kb, mb)
    with pytest.raises(ValueError):
        tref.rmsnorm(x, w, order="other")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    r = np.random.default_rng(1)
    xj, xt = pair(r.normal(size=(2, 9, 4, 64)), dtype)
    pos = r.integers(0, 300, (2, 9)).astype(np.int32)
    want = jlayers.apply_rope(xj, jnp.asarray(pos), 10_000.0)
    got = tlayers.apply_rope(xt, torch.from_numpy(pos), 10_000.0)
    assert got.dtype == xt.dtype
    # float32: cos/sin of angles up to 300 rad, ulp-level differences
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        tlayers.rope_freqs(64, 1e6).numpy(),
        np.asarray(jlayers.rope_freqs(64, 1e6)), rtol=1e-6)


def configs(arch, **kw):
    j = jreduced(arch).replace(**kw)
    return j, convert.model_config_from_dict(dataclasses.asdict(j))


def params_pair(specs_fn, jcfg, tcfg, seed):
    from repro.models.common import init_tree, spec_with_dtype
    jp = init_tree(spec_with_dtype(specs_fn(jcfg), jcfg.pdtype),
                   jax.random.key(seed))
    tp = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(tcfg.pdtype), jp)
    return jp, tp


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_mlp"])
def test_mlp_matches_reference(act):
    jcfg, tcfg = configs("smollm-135m", act=act)
    jp, tp = params_pair(jlayers.mlp_specs, jcfg, tcfg, 3)
    assert set(tp) == set(tlayers.mlp_specs(tcfg))
    x = np.random.default_rng(2).normal(size=(2, 5, 128)).astype(np.float32)
    want = jlayers.mlp(jp, jcfg, jnp.asarray(x))
    got = tlayers.mlp(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_unembed_match_reference(tie):
    jcfg, tcfg = configs("smollm-135m", tie_embeddings=tie)
    jp, tp = params_pair(jlayers.embed_specs, jcfg, tcfg, 4)
    assert ("unembed" in tp) == (not tie)
    toks = np.random.default_rng(3).integers(0, 512, (3, 7)).astype(np.int32)
    xj = jlayers.embed(jp, jnp.asarray(toks), jcfg)
    xt = tlayers.embed(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(
        tlayers.unembed(tp, xt, tcfg).numpy(),
        np.asarray(jlayers.unembed(jp, xj, jcfg)), rtol=1e-5, atol=1e-6)
