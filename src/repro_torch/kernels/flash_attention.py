"""Blockwise (flash) attention: the hand-written CUDA kernels' wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py`` (``_flash_kernel``,
wrapper ``flash_attention``). Both bodies in ``csrc/flash_attention.cu``
compute what it computes: online-softmax attention over tiles of keys with
float32 running max, denominator and accumulator, causal tiles above the
diagonal skipped, GQA by mapping query head ``h`` to kv head
``h // (H / Hkv)`` (no K/V replication), output in q's dtype. Both read
their inputs in place through strides, so the model's ``(B, S, H, d)``
layout costs no copy, and take any S (the tail tile is masked).

What bounds it on an H100: bytes (at the prefill shape (64, 9, 128, 64)
bf16, ~25 MB moved against ~1.2 GFLOP). ``body_for(dtype, d)`` picks the
body, from the dtype and head dim alone:

- ``"tensor_cores"`` — bf16 at a head dim with a compiled instance
  (``TC_HEAD_DIMS``): FlashAttention-2's structure on ``mma.sync``
  m16n8k16 bf16 with float32 accumulators, K/V double-buffered by
  ``cp.async``; the one rounding the TPU kernel does not have is P in bf16
  before P·V. The rows of q, k and v must start on 16 bytes;
- ``"cuda_cores"`` — every other case (float32 at any d ≤ 256, bf16 at
  another d): float32 products on the CUDA cores, the exact path float32
  needs.

Each body counts its launches in ``flash_attention.launches_by_body``;
``flash_attention.launches`` counts both. ``flash_attention_plain``
(``kernels.ref.flash_attention``) is the plain PyTorch version;
``kernels.ops.flash_attention`` chooses between it and the kernels by where
the tensors lie.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention as flash_attention_plain  # noqa: F401

MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (32, 64, 80, 96, 128)   # csrc/flash_attention.cu: instances
BODIES = ("tensor_cores", "cuda_cores")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_launch = {"tensor_cores": _build.Launcher("repro_flash_attention_tc"),
           "cuda_cores": _build.Launcher("repro_flash_attention")}


def body_for(dtype: torch.dtype, d: int) -> str:
    """Which kernel body runs attention of this dtype and head dim."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def _refuse(q, k, v) -> None:
    """Raise the error for arguments the kernels do not take."""
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(
                f"flash_attention: {name} must be contiguous in its last axis")
    raise ValueError("flash_attention: arguments not taken by the kernel")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    layout: str = "bhsd") -> torch.Tensor:
    """layout ``"bhsd"``: q (B, H, S, d), k/v (B, Hkv, S, d); ``"bshd"``
    (the models'): q (B, S, H, d), k/v (B, S, Hkv, d). ``H % Hkv == 0``;
    all on the current CUDA device, one dtype (float32 or bfloat16), last
    axis contiguous (the other axes may be strided views). Returns the
    attention in q's layout and dtype, a fresh contiguous tensor."""
    if layout == "bhsd":
        ax_h, ax_s = 1, 2
    elif layout == "bshd":
        ax_h, ax_s = 2, 1
    else:
        raise ValueError(f"flash_attention: unknown layout {layout!r}")
    dt = _DTYPE_CODE.get(q.dtype)
    ok = (q.is_cuda and q.dim() == 4 and k.dim() == 4 and dt is not None
          and k.dtype == q.dtype and v.dtype == q.dtype)
    if ok:
        B, H, S, d = q.shape[0], q.shape[ax_h], q.shape[ax_s], q.shape[3]
        Hkv = k.shape[ax_h]
        dev = q.get_device()
        ok = (k.shape[0] == B and k.shape[ax_s] == S and k.shape[3] == d
              and v.shape == k.shape and Hkv > 0 and H % Hkv == 0
              and d <= MAX_HEAD_DIM
              and k.get_device() == dev and v.get_device() == dev
              and q.stride(3) == 1 and k.stride(3) == 1
              and v.stride(3) == 1)
    if not ok:   # one condition; the message only on failure
        if layout == "bshd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        _refuse(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    strides = (qs[0], qs[ax_h], qs[ax_s], ks[0], ks[ax_h], ks[ax_s],
               vs[0], vs[ax_h], vs[ax_s], os_[0], os_[ax_h], os_[ax_s])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    body = body_for(q.dtype, d)
    if body == "tensor_cores" and (
            (ptrs[0] | ptrs[1] | ptrs[2]) & 15
            or (qs[0] | qs[1] | qs[2] | ks[0] | ks[1] | ks[2] | vs[0] | vs[1]
                | vs[2]) & 7):
        raise ValueError(
            "flash_attention: the bf16 tensor-core body copies whole 16-byte "
            "rows: q, k and v must start on 16 bytes and their batch, head "
            "and sequence strides be multiples of 8 elements")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    launch = _launch[body]
    err = launch.call(launch.pack(
        *ptrs, B, H, Hkv, S, d, scale, 1 if causal else 0, dt, *strides,
        _build.stream_on(dev)))
    if err != 0:
        raise RuntimeError(
            f"flash_attention: kernel launch failed (CUDA error {err})")
    flash_attention.launches += 1
    flash_attention.launches_by_body[body] += 1
    return out


flash_attention.launches = 0  # kernel launches made by this wrapper
flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
