"""RMSNorm: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py`` (``_rmsnorm_kernel``,
wrapper ``rmsnorm``), and is also the port's model norm
(``models.layers.rmsnorm``). The kernel is ``csrc/rmsnorm.cu``: float32
statistics, one warp per row, output in x's dtype, with the rounding order
as an argument — ``"kernel"`` (the TPU kernel's: ``x * r * w`` in float32,
one cast) or ``"model"`` (the JAX models' ``layers.rmsnorm``: ``x * r``
cast to x's dtype, times ``w`` cast to x's dtype).

What bounds it on an H100: bytes, and at the decode step's (64, 576) bf16
far less than a launch. The kernel reads each row once, as 16-byte vectors
held in registers; the wrapper's host path is one condition, one
``empty_like``, one packed-struct ``ctypes`` call on the current raw stream
(``_build.Launcher``, ``_build.stream_on``): the decode step calls it 61
times.

``rmsnorm_plain`` (``kernels.ref.rmsnorm``) is the plain PyTorch version;
``kernels.ops.rmsnorm`` chooses between the two by where the tensors lie.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain  # noqa: F401

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ORDER_CODE = {"kernel": 0, "model": 1}
_launch = _build.Launcher("repro_rmsnorm")


def _refuse(x: torch.Tensor, w: torch.Tensor, order: str) -> None:
    """Raise the error for arguments the kernel does not take."""
    if not x.is_cuda:
        raise ValueError(
            "rmsnorm: the kernel takes CUDA tensors; for CPU tensors call "
            "kernels.ops.rmsnorm (plain version)")
    if order not in _ORDER_CODE:
        raise ValueError(f"rmsnorm: order must be 'kernel' or 'model', got {order!r}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"rmsnorm: x and w must be float32 or bfloat16, got {x.dtype}/{w.dtype}")
    D = x.shape[-1] if x.dim() else None
    if w.dim() != 1 or w.shape[0] != D:
        raise ValueError(f"rmsnorm: w has shape {tuple(w.shape)}, expected ({D},)")
    if w.device != x.device:
        raise ValueError("rmsnorm: x and w on different devices")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("rmsnorm: x and w must be contiguous")
    raise ValueError("rmsnorm: arguments not taken by the kernel")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
            order: str = "kernel") -> torch.Tensor:
    """x: (..., D) contiguous, float32 or bfloat16; w: (D,) float32 or
    bfloat16; both on the current CUDA device. Returns x's shape and
    dtype."""
    xd, wd = _DTYPE_CODE.get(x.dtype), _DTYPE_CODE.get(w.dtype)
    oc = _ORDER_CODE.get(order)
    dev = x.get_device()
    if (dev < 0 or xd is None or wd is None or oc is None
            or w.shape != x.shape[-1:] or w.get_device() != dev
            or not x.is_contiguous() or not w.is_contiguous()):
        _refuse(x, w, order)   # one condition; the message only on failure
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    D = x.shape[-1]
    err = _launch.call(_launch.pack(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n // D, D, eps, xd, wd,
        oc, _build.stream_on(dev)))
    if err != 0:
        raise RuntimeError(f"rmsnorm: kernel launch failed (CUDA error {err})")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0  # kernel launches made by this wrapper
