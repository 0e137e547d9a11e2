"""Blockwise (flash) attention: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py`` (``_flash_kernel``,
wrapper ``flash_attention``). The kernel is ``csrc/flash_attention.cu``:
online-softmax attention over tiles of keys with float32 running max,
denominator and accumulator, causal tiles above the diagonal skipped, GQA by
mapping query head ``h`` to kv head ``h // (H / Hkv)`` (no K/V
replication), output in q's dtype.

What bounds it on an H100: bytes (at the prefill shape (64, 9, 128, 64)
bf16, ~25 MB moved against ~1.2 GFLOP). The first design is the simple,
right one — CUDA cores, one CTA per (batch*head, 32 query rows), one K/V
tile in shared memory at a time — and reads its inputs in place through
strides, so the model's ``(B, S, H, d)`` layout costs no copy.

Unlike the TPU kernel it needs no padding: any S (the tail tile is masked)
and any head dim up to 256. ``flash_attention_plain``
(``kernels.ref.flash_attention``) is the plain PyTorch version;
``kernels.ops.flash_attention`` chooses between the two by where the
tensors lie.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as flash_attention_plain  # noqa: F401

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _strides(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    if t.stride(3) != 1:
        raise ValueError(
            f"flash_attention: {name} must be contiguous in its last axis")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, Hkv, S, d), ``H % Hkv == 0``; all on one
    CUDA device, one dtype (float32 or bfloat16), last axis contiguous (the
    other axes may be strided views). Returns (B, H, S, d) in q's dtype —
    a fresh tensor, or ``out`` (any strides with a contiguous last axis)."""
    if not q.is_cuda:
        raise ValueError(
            "flash_attention: the kernel takes CUDA tensors; for CPU tensors "
            "call kernels.ops.flash_attention (plain version)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, d)")
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, d) or tuple(v.shape) != (B, Hkv, S, d):
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q/k/v must share float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}")
    if out is None:
        out = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    elif (tuple(out.shape) != (B, H, S, d) or out.dtype != q.dtype
          or out.device != q.device):
        raise ValueError("flash_attention: out does not match q")
    strides = (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
               *_strides(out, "out"))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Hkv, S, d, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], *strides, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: kernel launch failed (CUDA error {err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches made by this wrapper
