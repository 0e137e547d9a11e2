"""The port's plain flash attention (what the CUDA kernel is held to on the
card) against the JAX package's Pallas kernel in interpret mode
(``ops.flash_attention(..., layout="bhsd")``) and its oracle
``ref.flash_attention``, on the same numpy inputs: GQA, MQA, an odd head
dim, causal or not, float32 and bfloat16; and the ``bshd`` dispatch against
the model's einsum ``sdpa``.

Tolerances are those of the JAX package's own kernel tests
(``tests/test_kernels.py``): float32 2e-5, bfloat16 2.5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
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
