"""Free-style Gomoku (five-in-a-row) in plain PyTorch — the second ``Game``
workload (port of ``repro.core.gomoku``).

Board cells are indexed row-major on an n x n square; a *move* is the flat
index of an empty cell; a player wins by owning five (or more — free-style)
consecutive cells along a row, column, or either diagonal, and a full board
with no five is a DRAW — the protocol's first non-win outcome, exercising
the draw path through backup (credit 0.5), UCT, and root merging.

Everything a search consumes is batched over a (W, n_cells) tile with no
per-lane loops:

- the win test is four directional 5-window scans built from STATIC flat
  ``roll`` shifts + per-cell window-validity masks: window(i, dir) is
  monochrome iff the AND of 5 shifted stone masks holds at i;
- the fused ``playout_batch`` never steps move-by-move. It draws the same
  parity fill as Hex (``game.empty_fill_ranks``: rank k among the empties
  = the k-th playout move) and resolves the outcome by COMPLETION TIME: a
  window monochrome in the fully-filled board was completed exactly when
  its last cell was placed (stones are never removed), so its completion
  time is the max fill rank over its 5 cells (pre-existing stones count as
  rank -1). The playout's winner is the color of the window with minimal
  completion time; no five anywhere -> draw (0). ``playout_scalar`` is the
  sequential oracle (same RNG stream, one stone at a time).

Two windows of different colors cannot complete at the same time (a window
completes on its own color's placement), so the min-time comparison needs no
tie-break; on illegal boards where BOTH colors already contain a five
(unreachable through the search: ``legal_mask`` is empty at won positions)
the evaluation returns a draw.

The win tests go through ``kernels.ops.gomoku_winner`` /
``ops.gomoku_first_winner``, whose PyTorch bodies (here) serve the card and
the CPU alike, as the JAX package's one jnp body serves the TPU and the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import game as game_mod

EMPTY = 0
BLACK = 1
WHITE = 2

WIN_RUN = 5  # free-style five-in-a-row

# the four scan directions as (row, col) steps: E, S, SE, SW
_DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))


class GomokuSpec(NamedTuple):
    """Static board description (python ints)."""

    size: int

    @property
    def n_cells(self) -> int:
        return self.size * self.size


@functools.lru_cache(maxsize=None)
def _window_tables(size: int):
    """Per direction: flat shift offset + bool mask of valid window starts.

    Cell i starts a 5-window in direction (dr, dc) iff all of
    i, i+off, ..., i+4*off stay on the board along that line; ``roll``
    wrap-around artifacts land only on masked-out starts.
    """
    n = size * size
    offs, masks = [], []
    for dr, dc in _DIRS:
        m = np.zeros(n, dtype=bool)
        for r in range(size):
            for c in range(size):
                rr, cc = r + (WIN_RUN - 1) * dr, c + (WIN_RUN - 1) * dc
                if 0 <= rr < size and 0 <= cc < size:
                    m[r * size + c] = True
        offs.append(dr * size + dc)
        masks.append(m)
    return tuple(offs), np.stack(masks)


@functools.lru_cache(maxsize=None)
def _device_masks(size: int, device: torch.device) -> torch.Tensor:
    """The (4, n) window-start masks on ``device`` (cached: the hot path
    uploads nothing)."""
    return torch.as_tensor(_window_tables(size)[1], device=device)


def empty_board(spec: GomokuSpec, device=None) -> torch.Tensor:
    device = torch.device("cuda") if device is None else torch.device(device)
    return torch.zeros(spec.n_cells, dtype=torch.int8, device=device)


def place(board: torch.Tensor, move, player) -> torch.Tensor:
    """Place `player`'s stone at flat index `move` (no legality check).

    Batched over leading axes, as ``core.hex.place``; ``move`` must be a
    valid cell index (a negative one is not wrapped).
    """
    dev = board.device
    mv = torch.as_tensor(move, device=dev).to(torch.int64)
    pl = torch.as_tensor(player, device=dev).to(torch.int8)
    lead = board.shape[:-1]
    return board.scatter(-1, mv.expand(lead)[..., None],
                         pl.expand(lead)[..., None])


# ------------------------------------------------- batched (W, cells) ops ----
def five_windows_batch(stones: torch.Tensor, spec: GomokuSpec) -> torch.Tensor:
    """(W, n) bool -> (W, 4, n): window at start i (dir d) is all-stones.

    Four directional run scans, each the AND of five statically-shifted
    copies of the stone mask — no gathers, no per-lane loops.
    """
    offs, _ = _window_tables(spec.size)
    masks = _device_masks(spec.size, stones.device)
    outs = []
    for off, mk in zip(offs, masks):
        acc = stones
        for k in range(1, WIN_RUN):
            acc = acc & torch.roll(stones, -k * off, dims=1)
        outs.append(acc & mk[None, :])
    return torch.stack(outs, dim=1)


def has_five_batch(boards: torch.Tensor, player, spec: GomokuSpec) -> torch.Tensor:
    """(W, n) boards -> (W,) bool: does `player` (an int, or one per lane)
    own a completed five?"""
    if isinstance(player, int):
        # compared as a scalar: a Python int made into a CUDA tensor would
        # be a blocking host-to-device copy
        stones = boards == player
    else:
        stones = boards == torch.as_tensor(player, device=boards.device).to(
            torch.int8).expand(boards.shape[0])[:, None]
    return five_windows_batch(stones, spec).flatten(1).any(dim=1)


def terminal_batch(boards: torch.Tensor, spec: GomokuSpec) -> torch.Tensor:
    """(W, n) -> (W,) bool: a five exists, or the board is full (draw)."""
    full = ~(boards == EMPTY).any(dim=1)
    return (full | has_five_batch(boards, BLACK, spec)
            | has_five_batch(boards, WHITE, spec))


def winner_scan_batch(boards: torch.Tensor, spec: GomokuSpec) -> torch.Tensor:
    """Winner of TERMINAL boards: {1, 2} for a five, 0 for a full-board draw.

    CONTRACT: boards must be terminal (the search only evaluates positions
    the game has ended on); on a non-terminal board this returns 0, which is
    NOT "drawn" but "no five yet". Reached through the per-game dispatch
    ``kernels.ops.gomoku_winner``.
    """
    fb = has_five_batch(boards, BLACK, spec)
    fw = has_five_batch(boards, WHITE, spec)
    return torch.where(fb, BLACK, torch.where(fw, WHITE, EMPTY)).to(torch.int8)


def first_completion_winner(filled: torch.Tensor, times: torch.Tensor,
                            spec: GomokuSpec) -> torch.Tensor:
    """Outcome of a random fill by completion time (module docstring).

    filled: (W, n) int8 fully-filled boards; times: (W, n) int32 fill rank
    per cell, -1 for stones predating the playout. Returns (W,) int8 in
    {0 draw, 1, 2}.
    """
    big = spec.n_cells  # > any completion time
    offs, _ = _window_tables(spec.size)
    # the max fill rank over each window's five cells: shared by both colors
    win_times = []
    for off in offs:
        wt = times
        for k in range(1, WIN_RUN):
            wt = torch.maximum(wt, torch.roll(times, -k * off, dims=1))
        win_times.append(wt)

    def win_time(player):
        mono = five_windows_batch(filled == player, spec)     # (W, 4, n)
        best = None
        for d, wt in enumerate(win_times):
            cand = torch.where(mono[:, d], wt, big).amin(dim=1)  # (W,)
            best = cand if best is None else torch.minimum(best, cand)
        return best

    tb, tw = win_time(BLACK), win_time(WHITE)
    return torch.where(tb < tw, BLACK,
                       torch.where(tw < tb, WHITE, EMPTY)).to(torch.int8)


def playout_batch(boards: torch.Tensor, to_move, keys: torch.Tensor,
                  spec: GomokuSpec) -> torch.Tensor:
    """W random playouts fused into one (W, cells) evaluation stage.

    Same fill stream as Hex (one uniform (n,) draw per lane), outcome by
    completion time through the per-game dispatch
    ``kernels.ops.gomoku_first_winner`` — no move-by-move loop.
    """
    from repro_torch.kernels import ops  # function-level: ops imports games

    empties = boards == EMPTY
    ranks = game_mod.empty_fill_ranks(boards, keys)
    colors = game_mod.parity_fill_colors(ranks, to_move)
    filled = torch.where(empties, colors, boards)
    times = torch.where(empties, ranks, -1)
    return ops.gomoku_first_winner(filled, times, spec.size)


def playout_scalar(board: torch.Tensor, to_move, key: torch.Tensor,
                   spec: GomokuSpec) -> torch.Tensor:
    """Sequential per-lane playout oracle: place stones one at a time in the
    fill's rank order (argmin of the SAME uniform draw over the remaining
    empties, index tie-break matching ``empty_fill_ranks``), checking the
    placer's five after each move. Bit-identical to one lane of
    ``playout_batch`` — an independent incremental check of the
    completion-time formulation. One host read per stone."""
    u = rng.uniform(key, spec.n_cells)

    def five(b, p):
        return bool(has_five_batch(b[None], p, spec)[0])

    fb, fw = five(board, BLACK), five(board, WHITE)
    w = EMPTY if fb and fw else BLACK if fb else WHITE if fw else EMPTY
    done = fb or fw or not bool((board == EMPTY).any())
    b, p = board, int(to_move)
    while not done:
        pick = torch.argmin(torch.where(b == EMPTY, u, torch.inf))
        b = place(b, pick, p)
        won = five(b, p)
        w = p if won else w
        done = won or not bool((b == EMPTY).any())
        p = 3 - p
    return torch.tensor(w, dtype=torch.int8, device=board.device)


# ------------------------------------------------------- the Game protocol ----
class GomokuGame(NamedTuple):
    """Free-style Gomoku through the batched ``Game`` protocol.

    Differs from Hex in everything the protocol abstracts: the terminal
    test (first five ends the game mid-board), the legal-move set (empty at
    won positions, which is what stops the search expanding past a win),
    and the outcome range (draws). Sizes below 5 are legal but all-draw.
    """

    size: int

    @property
    def n_cells(self) -> int:
        return self.size * self.size

    @property
    def n_actions(self) -> int:
        return self.n_cells

    @property
    def max_moves(self) -> int:
        return self.n_cells

    @property
    def _spec(self) -> GomokuSpec:
        return GomokuSpec(self.size)

    def init_board(self, device=None) -> torch.Tensor:
        return empty_board(self._spec, device)

    def place(self, board, move, player) -> torch.Tensor:
        return place(board, move, player)

    def legal_mask(self, board) -> torch.Tensor:
        # no legal moves once a five exists: expansion stops, and the
        # playout of the (terminal) leaf returns the pre-existing winner
        # (its completion time -1 beats every fill rank). Batched over
        # leading axes.
        n = self.n_cells
        flat = board.reshape(-1, n)
        won = (has_five_batch(flat, BLACK, self._spec)
               | has_five_batch(flat, WHITE, self._spec))
        return ((flat == EMPTY) & ~won[:, None]).reshape(board.shape)

    def terminal_batch(self, boards) -> torch.Tensor:
        return terminal_batch(boards, self._spec)

    def winner_batch(self, boards) -> torch.Tensor:
        from repro_torch.kernels import ops

        return ops.gomoku_winner(boards, self.size)

    def playout_batch(self, boards, to_move, keys) -> torch.Tensor:
        return playout_batch(boards, to_move, keys, self._spec)

    def playout_scalar(self, board, to_move, key) -> torch.Tensor:
        return playout_scalar(board, to_move, key, self._spec)

    def replay_moves(self, moves, n_moves, first_player) -> torch.Tensor:
        return game_mod.replay_moves(moves, n_moves, first_player,
                                     self.n_cells)

    def winner_probe(self, board) -> torch.Tensor:
        # PARTIAL boards welcome (unlike winner_batch's terminal-only
        # contract): a five decides regardless of remaining space, a full
        # board without one is the draw, anything else is ongoing
        fb = bool(has_five_batch(board[None], BLACK, self._spec)[0])
        fw = bool(has_five_batch(board[None], WHITE, self._spec)[0])
        full = not bool((board == EMPTY).any())
        v = 1 if fb else 2 if fw else 0 if full else -1
        return torch.tensor(v, dtype=torch.int8, device=board.device)


game_mod.register_game("gomoku", GomokuGame)
