"""Dispatch points of the port's kernels.

The rule is the tensor's own device and nothing else: a tensor on the CPU
goes to the kernel's plain PyTorch version (``kernels.ref``), a tensor on a
CUDA device goes to the hand-written kernel, which launches or raises —
there is no fallback. ``plain_versions()`` is the one explicit override: a
context inside which CUDA tensors too go to the plain versions, so a whole
search can be run both ways on the card and compared.

The Gomoku win tests (``gomoku_winner``, ``gomoku_first_winner``) are the
exception: the JAX package has no Pallas body for them, only one jitted jnp
body for the TPU and the CPU alike, so their PyTorch bodies are the
dispatch target on both devices — not a fallback.

Call sites (``core/gscpm.py``, ``core/hex.py``, ``core/gomoku.py``, ``models/attention.py``,
``models/layers.py``, ``serve/mcts_decode.py``) go through these wrappers
only.
"""

from __future__ import annotations

import contextlib

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hex_playout as _hp
from repro_torch.kernels import hex_winner as _hw
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import select_descent as _sd
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


def select_descent(tree, root_board, game, cp, noise_keys, noise_scale: float):
    """One selection round of the batched search: every lane descends from
    the root to its leaf — the descent's dispatch point.

    Returns ``(paths, depths, leaves, boards, n_empty)``, as
    ``core.gscpm.select_batch`` documents them. On the card this is ONE
    launch of the descent kernel, for games with the shared board
    convention (``place`` writes the mover into the move's cell); otherwise
    the plain level loop (``core.gscpm.select_levels``). ``noise_keys``
    must be contiguous on the card.
    """
    if root_board.is_cuda and not _force_plain:
        return _sd.select_descent(tree, root_board, noise_keys, cp,
                                  noise_scale, game.max_moves + 1)
    return _ref.select_descent(tree, root_board, game, cp, noise_keys,
                               noise_scale)


def hex_playout(boards, to_move, keys, size: int):
    """W random Hex playouts — the playout phase's dispatch point.

    boards: (W, size*size) int8 leaf boards, to_move (W,) int32, keys (W, 2)
    int64; returns (W,) int8 winners. On the card one launch fills and
    judges every board; otherwise ``random_fill_batch`` + ``hex_winner``.
    """
    if boards.is_cuda and not _force_plain:
        return _hp.hex_playout(boards, to_move, keys, size)
    return _ref.hex_playout(boards, to_move, keys, size)


def hex_winner(boards, size: int):
    """Batched Hex winner of FILLED boards (``core.hex.winner_batch``; the
    search's playouts go through ``hex_playout``).

    boards: (W, size*size) FILLED boards; returns (W,) int8 winners. On
    the card this is always the pointer-doubling kernel; the batched flood
    fill (``core.hex.winner_flood_batch``) is an independent oracle, not a
    dispatch target.
    """
    if boards.is_cuda and not _force_plain:
        return _hw.hex_winner(boards, size)
    return _ref.hex_winner(boards, size)


def gomoku_winner(boards, size: int):
    """Batched Gomoku winner of TERMINAL boards (``core.gomoku.
    winner_scan_batch``): (W, size*size) int8 -> (W,) int8 in {0 draw, 1,
    2}. Four static-roll window scans; the PyTorch body is the target on
    the card and the CPU alike (module docstring)."""
    from repro_torch.core import gomoku as gm
    return gm.winner_scan_batch(boards, gm.GomokuSpec(size))


def gomoku_first_winner(filled, times, size: int):
    """Gomoku playout outcome by completion time over a random fill — the
    playout phase's dispatch point for ``gomoku``, as ``hex_playout`` is for
    ``hex``. filled: (W, size*size) int8 filled boards; times: (W,
    size*size) int32 fill rank per cell (-1 for pre-playout stones); returns
    (W,) int8 in {0 draw, 1, 2}. The PyTorch body
    (``core.gomoku.first_completion_winner``) is the target on both
    devices."""
    from repro_torch.core import gomoku as gm
    return gm.first_completion_winner(filled, times, gm.GomokuSpec(size))


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    layout: str = "bshd"):
    """Flash attention. layout ``"bshd"`` (the models': q (B, S, H, d), k/v
    (B, S, Hkv, d)) or ``"bhsd"``. On the card the kernel reads either
    layout in place through strides and writes its output in q's layout:
    no copies."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"flash_attention: unknown layout {layout!r}")
    if q.is_cuda and not _force_plain:
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                   layout=layout)
    bshd = layout == "bshd"
    if bshd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    out = _ref.flash_attention(q, k, v, causal=causal, scale=scale)
    return out.transpose(1, 2) if bshd else out


def rmsnorm(x, w, eps: float = 1e-5, order: str = "kernel"):
    """RMSNorm over the last axis; ``order`` is ``"kernel"`` (the TPU
    kernel's rounding) or ``"model"`` (the JAX models' ``layers.rmsnorm``)."""
    if x.is_cuda and not _force_plain:
        return _rn.rmsnorm(x, w, eps=eps, order=order)
    return _ref.rmsnorm(x, w, eps=eps, order=order)
