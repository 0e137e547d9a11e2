"""W Hex playouts (random fill + winner) in one launch: the hand-written
CUDA kernel's wrapper.

Replaces, on the search's path, the TPU kernel ``repro/kernels/hex_winner.py``
(``_winner_kernel``) together with the fill that feeds it. The plain
version (``core.hex.random_fill_batch`` + ``winner_batch``) spends ~190
eager launches on a threefry draw, the (W, n, n) rank compare of
``core.game.empty_fill_ranks`` and the parity colours before its one
connectivity solve. The kernel is ``hex_playout_kernel`` in
``csrc/hex_winner.cu``: one CTA per board draws the board's n uniforms
into shared memory (``csrc/threefry.cuh``), ranks each empty cell among the
empties with the same index tie-break, colours it by the rank's parity,
and runs the pointer-doubling labelling it shares with ``hex_winner``
(``black_winner``) for ``core.hex.doubling_rounds(n)`` rounds.

What bounds it on an H100: launch latency, then the rank count (E x n
compares for E empty cells) and the labelling rounds on shared memory; a
(256, 121) batch is 31 KB in and 256 bytes out. ``size`` is a run-time
argument (1 <= size <= 25).

``hex_playout_plain`` (``kernels.ref.hex_playout``) is the plain PyTorch
version; ``kernels.ops.hex_playout`` chooses by where the tensors lie.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import hex_playout as hex_playout_plain  # noqa: F401

MAX_SIZE = 25  # csrc/hex_winner.cu: kMaxCells == 625
_launch = _build.Launcher("repro_hex_playout")


def _refuse(boards, to_move, keys, size: int) -> None:
    """Raise the error for arguments the kernel does not take: the first
    wrong size, shape, dtype, device or layout, else the CPU."""
    if not isinstance(boards, torch.Tensor):
        raise TypeError("hex_playout: boards must be a tensor")
    if not 1 <= size <= MAX_SIZE:
        raise ValueError(f"hex_playout: size {size} outside 1..{MAX_SIZE}")
    if boards.dtype != torch.int8:
        raise TypeError(f"hex_playout: boards is {boards.dtype}, expected int8")
    if boards.dim() != 2 or boards.shape[1] != size * size:
        raise ValueError(
            f"hex_playout: boards shape {tuple(boards.shape)} != (W, size*size "
            f"= {size * size})")
    W = boards.shape[0]
    if W == 0:
        raise ValueError("hex_playout: empty batch")
    for name, t, shape, dtype in (("to_move", to_move, (W,), torch.int32),
                                  ("keys", keys, (W, 2), torch.int64)):
        if not isinstance(t, torch.Tensor) or t.device != boards.device:
            raise ValueError(f"hex_playout: {name} must be a tensor on "
                             f"{boards.device}")
        if t.dtype != dtype:
            raise TypeError(f"hex_playout: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"hex_playout: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in (("boards", boards), ("to_move", to_move), ("keys", keys)):
        if not t.is_contiguous():
            raise ValueError(f"hex_playout: {name} must be contiguous")
    raise ValueError(
        "hex_playout: the kernel takes CUDA tensors; for CPU tensors call "
        "kernels.ops.hex_playout (plain version)")


def hex_playout(boards: torch.Tensor, to_move: torch.Tensor,
                keys: torch.Tensor, size: int, with_filled: bool = False):
    """boards: (W, size*size) int8 leaf boards; to_move: (W,) int32, the
    player to move on each; keys: (W, 2) int64 playout keys. Returns (W,)
    int8 winners in {1, 2}, and with ``with_filled`` also the (W,
    size*size) int8 filled boards (for the checks; the search does not ask
    for them). Lane w fills exactly as ``core.hex.random_fill_batch`` does
    with ``keys[w]``. Launches on the current stream."""
    # the round budget is owned by core.hex (function-level import: kernels
    # must not depend on core at module scope)
    from repro_torch.core.hex import doubling_rounds

    ok = (isinstance(boards, torch.Tensor) and boards.is_cuda
          and boards.dtype == torch.int8 and boards.dim() == 2
          and 1 <= size <= MAX_SIZE and boards.shape[1] == size * size
          and boards.shape[0] > 0 and boards.is_contiguous())
    if ok:
        W, dev = boards.shape[0], boards.get_device()
        ok = (isinstance(to_move, torch.Tensor) and isinstance(keys, torch.Tensor)
              and to_move.dtype == torch.int32 and to_move.shape == (W,)
              and to_move.get_device() == dev and to_move.is_contiguous()
              and keys.dtype == torch.int64 and keys.shape == (W, 2)
              and keys.get_device() == dev and keys.is_contiguous())
    if not ok:   # one condition; the message only on failure
        _refuse(boards, to_move, keys, size)
    out = torch.empty((W,), dtype=torch.int8, device=boards.device)
    filled = torch.empty_like(boards) if with_filled else None
    err = _launch.call(_launch.pack(
        boards.data_ptr(), to_move.data_ptr(), keys.data_ptr(), W, size,
        doubling_rounds(size * size), out.data_ptr(),
        0 if filled is None else filled.data_ptr(), _build.stream_on(dev)))
    if err != 0:
        raise RuntimeError(f"hex_playout: kernel launch failed (CUDA error {err})")
    hex_playout.launches += 1
    return (out, filled) if with_filled else out


hex_playout.launches = 0  # kernel launches made by this wrapper
