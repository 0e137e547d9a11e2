"""Dispatch points of the port's kernels.

The rule is the tensor's own device and nothing else: a tensor on the CPU
goes to the kernel's plain PyTorch version (``kernels.ref``), a tensor on a
CUDA device goes to the hand-written kernel, which launches or raises —
there is no fallback. ``plain_versions()`` is the one explicit override: a
context inside which CUDA tensors too go to the plain versions, so a whole
search can be run both ways on the card and compared.

Call sites (``core/gscpm.py``, ``core/hex.py``, ``models/attention.py``,
``models/layers.py``, ``serve/mcts_decode.py``) go through these wrappers
only.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hex_winner as _hw
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import uct_select as _us

_force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Inside this context every dispatch takes the plain PyTorch version,
    whatever the device (comparison runs only; the default is the kernel)."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def uct_select(wins, visits, vloss, parent_total, valid, cp,
               noise=None, lane_mask=None):
    """Batched UCT child selection — the search hot path's dispatch point.

    (W, C) child stats -> (W,) int32 slots. ``cp`` is a run-time value on
    both paths: sweeping it compiles nothing.
    """
    if wins.is_cuda and not _force_plain:
        return _us.uct_select(wins, visits, vloss, parent_total, valid, cp,
                              noise=noise, lane_mask=lane_mask)
    return _ref.uct_select(wins, visits, vloss, parent_total, valid, cp,
                           noise=noise, lane_mask=lane_mask)


def hex_winner(boards, size: int):
    """Batched Hex winner evaluation — the playout phase's dispatch point.

    boards: (W, size*size) FILLED boards; returns (W,) int8 winners. On
    the card this is always the pointer-doubling kernel; the batched flood
    fill (``core.hex.winner_flood_batch``) is an independent oracle, not a
    dispatch target.
    """
    if boards.is_cuda and not _force_plain:
        return _hw.hex_winner(boards, size)
    return _ref.hex_winner(boards, size)


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    layout: str = "bshd"):
    """Flash attention. layout ``"bshd"`` (the models': q (B, S, H, d), k/v
    (B, S, Hkv, d)) or ``"bhsd"`` (the kernel's own). On the card the
    ``bshd`` tensors are handed to the kernel as strided views and its
    output is written straight into a (B, S, H, d) buffer: no copies."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"flash_attention: unknown layout {layout!r}")
    bshd = layout == "bshd"
    if bshd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if q.is_cuda and not _force_plain:
        if not bshd:
            return _fa.flash_attention(q, k, v, causal=causal, scale=scale)
        B, H, S, d = q.shape
        out = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
        _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                            out=out.transpose(1, 2))
        return out
    out = _ref.flash_attention(q, k, v, causal=causal, scale=scale)
    return out.transpose(1, 2) if bshd else out


def rmsnorm(x, w, eps: float = 1e-5, order: str = "kernel"):
    """RMSNorm over the last axis; ``order`` is ``"kernel"`` (the TPU
    kernel's rounding) or ``"model"`` (the JAX models' ``layers.rmsnorm``)."""
    if x.is_cuda and not _force_plain:
        return _rn.rmsnorm(x, w, eps=eps, order=order)
    return _ref.rmsnorm(x, w, eps=eps, order=order)
