"""Batched UCT child selection: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/uct_select.py`` (``_uct_kernel``,
wrapper ``uct_select``). The kernel is ``csrc/uct_select.cu``:

    UCT(j) = w_j/n_j + Cp * sqrt(ln(n_parent)/n_j)        (paper eq. 1)

with virtual loss folded into n_j, unvisited-first semantics (score 1e30),
invalid-slot masking (-1e30), done-lane masking (a finished lane's row is
all-invalid, so its pick is slot 0 and the caller holds it in place), and
bounded tie-break noise.

What bounds it on an H100: at the search's shapes the tile is well under a
megabyte, so neither bytes nor arithmetic matter next to the launch itself.
The design answers that by being ONE launch per descent level with no
padded copies: one warp per row, scores in registers, a shuffle reduction
with an explicit "greater score, else lower slot" rule (first-index
argmax). ``cp``, ``W`` and ``C`` are run-time arguments, so sweeping any of
them compiles nothing.

``uct_select_plain`` (``kernels.ref.uct_select``) is the plain PyTorch
version of the same function; ``kernels.ops.uct_select`` chooses between
the two by where the tensors lie.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import uct_select as uct_select_plain  # noqa: F401

BIG = 1e30
_launch = _build.Launcher("repro_uct_select")


def _fits(t, shape, dtype, device: int) -> bool:
    return (isinstance(t, torch.Tensor) and t.dtype == dtype
            and t.shape == shape and t.get_device() == device
            and t.is_contiguous())


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"uct_select: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"uct_select: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"uct_select: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"uct_select: {name} has shape {tuple(t.shape)}, expected "
            f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"uct_select: {name} must be contiguous")


def _refuse(wins, visits, vloss, parent_total, valid, noise,
            lane_mask) -> None:
    """Raise the error for arguments the kernel does not take."""
    if not wins.is_cuda:
        raise ValueError(
            "uct_select: the kernel takes CUDA tensors; for CPU tensors call "
            "kernels.ops.uct_select (plain version)")
    if wins.dim() != 2:
        raise ValueError(f"uct_select: wins must be (W, C), got {tuple(wins.shape)}")
    W, C = wins.shape
    dev = wins.device
    f32, b8 = torch.float32, torch.bool
    _check("wins", wins, (W, C), f32, dev)
    _check("visits", visits, (W, C), f32, dev)
    _check("vloss", vloss, (W, C), f32, dev)
    _check("parent_total", parent_total, (W,), f32, dev)
    _check("valid", valid, (W, C), b8, dev)
    if noise is not None:
        _check("noise", noise, (W, C), f32, dev)
    if lane_mask is not None:
        _check("lane_mask", lane_mask, (W,), b8, dev)
    raise ValueError("uct_select: arguments not taken by the kernel")


def uct_select(wins: torch.Tensor, visits: torch.Tensor, vloss: torch.Tensor,
               parent_total: torch.Tensor, valid: torch.Tensor, cp,
               noise: torch.Tensor | None = None,
               lane_mask: torch.Tensor | None = None) -> torch.Tensor:
    """wins/visits/vloss/noise: (W, C) f32; valid: (W, C) bool;
    parent_total: (W,) f32; lane_mask: (W,) bool. Returns (W,) int32.

    Launches the CUDA kernel on the current stream; the tensors must lie on
    the current CUDA device. ``lane_mask`` marks live lanes; a False row is
    fully invalid and deterministically selects slot 0.
    """
    f32, b8 = torch.float32, torch.bool
    ok = wins.is_cuda and wins.dim() == 2
    if ok:
        tile, dev = wins.shape, wins.get_device()
        row = tile[:1]
        ok = (_fits(wins, tile, f32, dev) and _fits(visits, tile, f32, dev)
              and _fits(vloss, tile, f32, dev)
              and _fits(parent_total, row, f32, dev)
              and _fits(valid, tile, b8, dev)
              and (noise is None or _fits(noise, tile, f32, dev))
              and (lane_mask is None or _fits(lane_mask, row, b8, dev)))
    if not ok:   # one condition; the message only on failure
        _refuse(wins, visits, vloss, parent_total, valid, noise, lane_mask)
    W, C = tile
    out = torch.empty((W,), dtype=torch.int32, device=wins.device)
    err = _launch.call(_launch.pack(
        wins.data_ptr(), visits.data_ptr(), vloss.data_ptr(),
        parent_total.data_ptr(), valid.data_ptr(),
        0 if noise is None else noise.data_ptr(),
        0 if lane_mask is None else lane_mask.data_ptr(),
        float(cp), W, C, out.data_ptr(), _build.stream_on(dev)))
    if err != 0:
        raise RuntimeError(f"uct_select: kernel launch failed (CUDA error {err})")
    uct_select.launches += 1
    return out


uct_select.launches = 0  # kernel launches made by this wrapper
