"""Batched Hex winner: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/hex_winner.py`` (``_winner_kernel``,
wrapper ``hex_winner``). The kernel is ``csrc/hex_winner.cu``: all W boards'
BLACK connectivity at once by pointer doubling (Shiloach–Vishkin / FastSV
hook-and-jump) for exactly ``core.hex.doubling_rounds(n)`` rounds.

What bounds it on an H100: a (256, 121) int8 batch is 31 KB, so the launch
itself dominates, then the integer work on shared memory. The design: one
CTA per board, stone mask and label arrays in shared memory, the six Hex
neighbours by indexed shared loads with in-bounds tests, the scatter-min
hook by ``atomicMin``, the jump by a shared-memory gather, a barrier
between phases so the labels after every round equal the plain version's.
None of the TPU kernel's one-hot (C, C) gather/scatter is carried over.
``size`` is a run-time argument (2 ≤ size ≤ 25).

``hex_winner_plain`` (``kernels.ref.hex_winner``) is the plain PyTorch
version; ``kernels.ops.hex_winner`` chooses by where the tensor lies.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import hex_winner as hex_winner_plain  # noqa: F401

MAX_SIZE = 25  # csrc/hex_winner.cu: kMaxCells == 625
_launch = _build.Launcher("repro_hex_winner")


def _refuse(boards, size: int) -> None:
    """Raise the error for arguments the kernel does not take."""
    if not isinstance(boards, torch.Tensor) or not boards.is_cuda:
        raise ValueError(
            "hex_winner: the kernel takes a CUDA tensor; for CPU tensors call "
            "kernels.ops.hex_winner (plain version)")
    if boards.dtype != torch.int8:
        raise TypeError(f"hex_winner: boards is {boards.dtype}, expected int8")
    if boards.dim() != 2 or boards.shape[1] != size * size:
        raise ValueError(
            f"hex_winner: boards shape {tuple(boards.shape)} != (W, size*size "
            f"= {size * size})")
    if not 1 <= size <= MAX_SIZE:
        raise ValueError(f"hex_winner: size {size} outside 1..{MAX_SIZE}")
    if not boards.is_contiguous():
        raise ValueError("hex_winner: boards must be contiguous")
    raise ValueError("hex_winner: empty batch")


def hex_winner(boards: torch.Tensor, size: int) -> torch.Tensor:
    """boards: (W, size*size) int8 FILLED boards on the current CUDA device.
    Returns (W,) int8 winners in {1, 2}.

    Same contract as ``repro_torch.core.hex.winner``: boards must be
    completely filled (the Hex-theorem single connectivity check is only a
    winner check on terminal boards). Launches on the current stream.
    """
    # the round budget is owned by core.hex (function-level import: kernels
    # must not depend on core at module scope) so kernel and plain paths
    # can never drift apart
    from repro_torch.core.hex import doubling_rounds

    if not (isinstance(boards, torch.Tensor) and boards.is_cuda
            and boards.dtype == torch.int8 and boards.dim() == 2
            and boards.shape[1] == size * size and 1 <= size <= MAX_SIZE
            and boards.is_contiguous() and boards.shape[0] > 0):
        _refuse(boards, size)   # one condition; the message only on failure
    W = boards.shape[0]
    out = torch.empty((W,), dtype=torch.int8, device=boards.device)
    err = _launch.call(_launch.pack(
        boards.data_ptr(), W, size, doubling_rounds(size * size),
        out.data_ptr(), _build.stream_on(boards.get_device())))
    if err != 0:
        raise RuntimeError(f"hex_winner: kernel launch failed (CUDA error {err})")
    hex_winner.launches += 1
    return out


hex_winner.launches = 0  # kernel launches made by this wrapper
