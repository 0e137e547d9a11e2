"""The port's plain flash attention (what the CUDA kernel is held to on the
card) against the JAX package's Pallas kernel in interpret mode
(``ops.flash_attention(..., layout="bhsd")``) and its oracle
``ref.flash_attention``, on the same numpy inputs: GQA, MQA, an odd head
dim, causal or not, float32 and bfloat16; and the ``bshd`` dispatch against
the model's einsum ``sdpa``.

Tolerances are those of the JAX package's own kernel tests
(``tests/test_kernels.py``): float32 2e-5, bfloat16 2.5e-2.

The bf16 tensor-core body rounds P to bf16 before P·V, which no TPU-side
product does: ``tc_body_emulation`` repeats that body's arithmetic in torch
and is held to the bf16 tolerance on every bf16 shape ``chip_smoke.py``
checks on the card, so the one new rounding is tried before the card.
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2.5e-2}
SHAPES = [  # B, H, Hkv, S, d
    (2, 4, 2, 128, 64),    # GQA
    (1, 8, 1, 128, 128),   # MQA
    (2, 2, 2, 128, 80),    # odd head dim (the TPU kernel pads it to 128)
    (1, 4, 2, 32, 64),     # S below one block
]


ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def qkv(B, H, Hkv, S, d, dtype, seed):
    r = np.random.default_rng(seed)
    out = []
    for heads in (H, Hkv, Hkv):
        a = jnp.asarray(r.normal(size=(B, heads, S, d)).astype(np.float32))
        a = a.astype(dtype)
        out.append((a, torch.from_numpy(np.array(a.astype(jnp.float32)))
                    .to(getattr(torch, dtype))))
    return out


def close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_flash_matches_pallas_interpret_and_reference(shape, dtype):
    (qj, qt), (kj, kt), (vj, vt) = qkv(*shape, dtype, seed=sum(shape))
    got = tref.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    close(got, jops.flash_attention(qj, kj, vj, causal=True, layout="bhsd",
                                    interpret=True), dtype)
    close(got, jref.flash_attention(qj, kj, vj, causal=True), dtype)
    # on a CPU tensor the dispatch point is the plain version itself
    assert torch.equal(tops.flash_attention(qt, kt, vt, layout="bhsd"), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_noncausal_matches_reference(dtype):
    (qj, qt), (kj, kt), (vj, vt) = qkv(2, 4, 2, 128, 64, dtype, seed=11)
    got = tref.flash_attention(qt, kt, vt, causal=False, scale=0.3)
    close(got, jops.flash_attention(qj, kj, vj, causal=False, scale=0.3,
                                    layout="bhsd", interpret=True), dtype)
    close(got, jref.flash_attention(qj, kj, vj, causal=False, scale=0.3),
          dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bshd_dispatch_matches_model_sdpa(dtype):
    """The model's layout through the dispatch point equals the JAX model's
    causal einsum sdpa (and the port's)."""
    B, H, Hkv, S, d = 2, 4, 2, 64, 32
    (qj, qt), (kj, kt), (vj, vt) = qkv(B, H, Hkv, S, d, dtype, seed=3)
    sw = lambda t: t.swapaxes(1, 2) if isinstance(t, jnp.ndarray) else t.transpose(1, 2)
    got = tops.flash_attention(sw(qt), sw(kt), sw(vt), causal=True)
    assert got.shape == (B, S, H, d)
    want = jattn.sdpa(sw(qj), sw(kj), sw(vj), jattn.causal_mask(S))
    close(got, want, dtype)
    close(tattn.sdpa(sw(qt), sw(kt), sw(vt), tattn.causal_mask(S)), want, dtype)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """On a CPU tensor the kernel wrapper raises (the dispatch point takes
    the plain version instead); shape errors are caught before any launch."""
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q[:, :2], q[:, :2])
    assert tfa.flash_attention.launches == 0
    with pytest.raises(ValueError):
        tops.flash_attention(q, q, q, layout="hsbd")


LOG2E = 1.4426950408889634
TC_TILE = 64   # keys per K/V tile of the tensor-core body


def tc_body_emulation(q, k, v, causal=True, scale=None):
    """The bf16 tensor-core body's arithmetic (``csrc/flash_attention.cu``,
    ``flash_tc_kernel``) in torch: bf16 q, k, v; float32 scores with the
    scale (times log2 e, in float32) applied to them; 64-key tiles with
    online rescaling by ``exp2``; P rounded to bf16 before P·V, the
    denominator summing P before that rounding; float32 accumulation; the
    output times ``1 / max(l, 1e-30)``, rounded to bf16. (The kernel's exp2
    is the special-function unit's, within ~2 ulp of this one: far below
    the bf16 rounding of P that is rehearsed here.)"""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    c = (torch.tensor(scale, dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32))
    qf = q.float().reshape(B, Hkv, G, S, d)
    kf, vf = k.float(), v.float()
    m = torch.full((B, Hkv, G, S, 1), -1e30)
    l = torch.zeros((B, Hkv, G, S, 1))
    acc = torch.zeros((B, Hkv, G, S, d))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, TC_TILE):
        kt, vt = kf[:, :, k0:k0 + TC_TILE], vf[:, :, k0:k0 + TC_TILE]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * c
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd",
                                         p.bfloat16().float(), vt)
        m = m_new
    o = acc * (1.0 / torch.clamp(l, min=1e-30))
    return o.reshape(B, H, S, d).to(q.dtype)


TC_SHAPES = [c for c in chip_smoke.FLASH_CASES
             if tfa.body_for(torch.bfloat16, c[-1]) == "tensor_cores"]


def test_tc_shapes_cover_the_card_checks():
    """Every bf16 shape chip_smoke.py holds the tensor-core body to on the
    card, S = 1024 and d = 128 among them, is rehearsed here."""
    assert (2, 9, 3, 1024, 64) in TC_SHAPES
    assert {c[-1] for c in TC_SHAPES} == set(tfa.TC_HEAD_DIMS)
    assert chip_smoke.FLASH_TOL == TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", TC_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tc_body_rounding_within_bf16_tolerance(shape, causal):
    """P in bf16 keeps the tensor-core body within FLASH_TOL["bfloat16"]
    of the JAX package's reference and of the port's plain version (both
    float32 softmax and products) on the same inputs."""
    (qj, qt), (kj, kt), (vj, vt) = qkv(*shape, "bfloat16", seed=sum(shape))
    got = tc_body_emulation(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    close(got, jref.flash_attention(qj, kj, vj, causal=causal), "bfloat16")
    close(got, tref.flash_attention(qt, kt, vt, causal=causal).float().numpy(),
          "bfloat16")


@pytest.mark.parametrize("d", [32, 64, 80, 96, 128])
def test_body_for_routes_bf16_instances_to_the_tensor_cores(d):
    assert tfa.body_for(torch.bfloat16, d) == "tensor_cores"
    assert tfa.body_for(torch.float32, d) == "cuda_cores"


@pytest.mark.parametrize("d", [16, 48, 100, 112, 160, 256])
def test_body_for_routes_other_head_dims_to_the_cuda_cores(d):
    assert tfa.body_for(torch.bfloat16, d) == "cuda_cores"
    assert tfa.body_for(torch.float32, d) == "cuda_cores"


def test_kernel_wrapper_counts_no_launch_by_body_on_cpu():
    q = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16)
    before = dict(tfa.flash_attention.launches_by_body)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q[:, :2], q[:, :2])
    assert tfa.flash_attention.launches_by_body == before
    assert set(before) == set(tfa.BODIES)
    assert _build._lib is None    # refused before any build
