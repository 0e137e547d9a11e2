"""RMSNorm: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py`` (``_rmsnorm_kernel``,
wrapper ``rmsnorm``), and is also the port's model norm
(``models.layers.rmsnorm``). The kernel is ``csrc/rmsnorm.cu``: float32
statistics, one warp per row, output in x's dtype, with the rounding order
as an argument — ``"kernel"`` (the TPU kernel's: ``x * r * w`` in float32,
one cast) or ``"model"`` (the JAX models' ``layers.rmsnorm``: ``x * r``
cast to x's dtype, times ``w`` cast to x's dtype).

What bounds it on an H100: bytes, and at the decode step's (64, 576) bf16
far less than a launch; the design is one launch per call, nothing padded.

``rmsnorm_plain`` (``kernels.ref.rmsnorm``) is the plain PyTorch version;
``kernels.ops.rmsnorm`` chooses between the two by where the tensors lie.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain  # noqa: F401

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ORDER_CODE = {"kernel": 0, "model": 1}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            order: str = "kernel") -> torch.Tensor:
    """x: (..., D) contiguous, float32 or bfloat16; w: (D,) float32 or
    bfloat16; both on one CUDA device. Returns x's shape and dtype."""
    if not x.is_cuda:
        raise ValueError(
            "rmsnorm: the kernel takes CUDA tensors; for CPU tensors call "
            "kernels.ops.rmsnorm (plain version)")
    if order not in _ORDER_CODE:
        raise ValueError(f"rmsnorm: order must be 'kernel' or 'model', got {order!r}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"rmsnorm: x and w must be float32 or bfloat16, got {x.dtype}/{w.dtype}")
    D = x.shape[-1]
    if w.dim() != 1 or w.shape[0] != D:
        raise ValueError(f"rmsnorm: w has shape {tuple(w.shape)}, expected ({D},)")
    if w.device != x.device:
        raise ValueError("rmsnorm: x and w on different devices")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("rmsnorm: x and w must be contiguous")
    N = x.numel() // max(D, 1)
    out = torch.empty_like(x)
    if N == 0:
        return out

    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_rmsnorm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), N, D, float(eps),
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _ORDER_CODE[order],
            stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm: kernel launch failed (CUDA error {err})")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0  # kernel launches made by this wrapper
