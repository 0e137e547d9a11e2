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
import struct

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
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import hex_winner as thw
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import uct_select as tus
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


def test_rmsnorm_kernel_wrapper_refuses_cpu_tensors():
    """On CPU tensors the kernel wrapper raises before any build or launch;
    the dispatch point takes the plain version."""
    x = torch.zeros(4, 576, dtype=torch.bfloat16)
    w = torch.ones(576)
    before = trn.rmsnorm.launches
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm(x, w, order="model")
    assert trn.rmsnorm.launches == before
    assert _build._lib is None
    assert torch.equal(tops.rmsnorm(x, w, order="model"),
                       tref.rmsnorm(x, w, order="model"))
    assert trn.rmsnorm_plain is tref.rmsnorm


def test_host_prelude_refuses_cpu_tensors():
    """The one prelude the four wrappers share gives no stream for a CPU
    tensor, and every wrapper refuses CPU tensors with the same message
    it gave before the prelude was shared."""
    with pytest.raises(ValueError, match="CPU"):
        _build.stream_on(torch.zeros(1).get_device())
    z = torch.zeros(8, 25)
    calls = [
        lambda: tus.uct_select(z, z, z, z[:, 0].contiguous(), z > 0, 1.0),
        lambda: thw.hex_winner(torch.ones(4, 25, dtype=torch.int8), 5),
        lambda: tfa.flash_attention(*(torch.zeros(1, 2, 8, 64),) * 3),
        lambda: trn.rmsnorm(z, torch.ones(25)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _build._lib is None


# one call's arguments for each entry point, as its wrapper packs them
# (pointers near the top of a 48-bit address space)
P = 0x7F00_0000_1230
LAUNCH_ARGS = {
    "repro_uct_select": (P, P, P, P, P, 0, 0, 1.0, 256, 121, P, P),
    "repro_hex_winner": (P, 256, 11, 9, P, P),
    "repro_select_descent": (*(P,) * 9, 1.0, 1e-3, 122, 8, 32, 121, 121,
                             1 << 18, *(P,) * 6),
    "repro_hex_playout": (P, P, P, 256, 11, 9, P, 0, P),
    "repro_flash_attention": (P, P, P, P, 64, 9, 3, 128, 64, 0.125, 1, 0,
                              *range(12), P),
    "repro_flash_attention_tc": (P, P, P, P, 64, 9, 3, 128, 64, 0.125, 1, 1,
                                 *range(12), P),
    "repro_rmsnorm": (P, P, P, 64, 576, 1e-5, 1, 1, 1, P),
}
# sizeof the C structs with 8-byte pointers and long longs, 4-byte int and
# float, each field at its natural alignment (what load() checks on the
# card against <entry>_args_bytes())
C_STRUCT_BYTES = {"repro_uct_select": 88, "repro_hex_winner": 40,
                  "repro_select_descent": 152, "repro_hex_playout": 64,
                  "repro_flash_attention": 168, "repro_flash_attention_tc": 168,
                  "repro_rmsnorm": 56}


@pytest.mark.parametrize("name", sorted(_build.ARGS))
def test_launcher_packs_the_c_struct(name):
    fmt = _build.ARGS[name]
    assert struct.calcsize(fmt) == C_STRUCT_BYTES[name]
    packed = struct.pack(fmt, *LAUNCH_ARGS[name])
    assert len(packed) == C_STRUCT_BYTES[name]
    assert struct.unpack(fmt, packed)[0] == P
    launcher = _build.Launcher(name)   # resolves (and builds) at first call
    assert launcher.call == launcher._first_call and _build._lib is None


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
