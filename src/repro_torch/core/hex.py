"""Hex game environment in plain PyTorch (port of ``repro.core.hex``).

The paper's benchmark application is a from-scratch 11x11 Hex engine. Board
cells are indexed row-major. Player 1 (BLACK) connects the TOP edge to the
BOTTOM edge; player 2 (WHITE) connects LEFT to RIGHT. A *move* is the flat
index of an empty cell.

The paper uses a disjoint-set (union-find) structure for connectivity.
Union-find is pointer-chasing and hostile to vector hardware, so there are
two vectorizable equivalents:

- a frontier flood-fill to a fixpoint — the scalar oracle
  (``connected``/``winner``), O(board diameter) steps; its batched
  gather-free twin is ``winner_flood_batch``;
- **batched pointer-doubling** connected-component labeling
  (``cc_labels_batch`` / ``connected_batch``) — the Shiloach–Vishkin/FastSV
  hook-and-jump scheme over a whole (W, n_cells) tile at once, converging
  in O(log n_cells) rounds: the formulation the hand-written CUDA kernel
  ``kernels/hex_winner.py`` runs on the card.

``winner_batch`` goes through ``kernels.ops.hex_winner``: on a CUDA tensor
that is always the pointer-doubling kernel; the flood fill stays as an
independent oracle. ``playout_batch`` goes through ``kernels.ops.hex_playout``:
on a CUDA tensor one kernel launch does the fill and the same labelling.

The playout exploits the Hex theorem: a completely filled board has exactly
one winner, so a playout = randomly fill all empty cells with alternating
stones, then run ONE connectivity check for BLACK (if BLACK is not connected,
WHITE is). ``playout_batch`` fuses place→fill→winner for W lanes: one
sort-free fill pass + one connectivity solve per sync iteration.

Boards are int8, ids and labels int32 at every function boundary; index
tensors are widened to int64 only where a torch op demands it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import game as game_mod

EMPTY = 0
BLACK = 1  # connects top <-> bottom
WHITE = 2  # connects left <-> right


class HexSpec(NamedTuple):
    """Static board description (python ints)."""

    size: int

    @property
    def n_cells(self) -> int:
        return self.size * self.size


def neighbor_table(size: int) -> np.ndarray:
    """(n_cells, 6) int32 neighbor indices; `n_cells` acts as a pad sentinel.

    Hex adjacency on a rhombus: (r-1,c), (r-1,c+1), (r,c-1), (r,c+1),
    (r+1,c-1), (r+1,c).
    """
    n = size * size
    tbl = np.full((n, 6), n, dtype=np.int32)
    for r in range(size):
        for c in range(size):
            i = r * size + c
            for k, (dr, dc) in enumerate(_DELTAS):
                rr, cc = r + dr, c + dc
                if 0 <= rr < size and 0 <= cc < size:
                    tbl[i, k] = rr * size + cc
    return tbl


@functools.lru_cache(maxsize=None)
def _static_tables(size: int):
    """Neighbor table + edge masks as numpy constants (cached per size)."""
    n = size * size
    nbr = neighbor_table(size)
    top = np.zeros(n, dtype=bool)
    top[:size] = True
    bottom = np.zeros(n, dtype=bool)
    bottom[n - size:] = True
    left = np.zeros(n, dtype=bool)
    left[::size] = True
    right = np.zeros(n, dtype=bool)
    right[size - 1:: size] = True
    return nbr, top, bottom, left, right


# the six hex neighbors as (row, col) offsets on the rhombus board
_DELTAS = ((-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0))


@functools.lru_cache(maxsize=None)
def _shift_tables(size: int):
    """Neighborhood as six STATIC flat shifts + per-cell validity masks.

    The gather-free formulation of hex adjacency: the neighbor of cell i in
    direction (dr, dc) sits at flat offset dr*size + dc, so a whole
    (W, n_cells) tile reads it with one roll.
    """
    n = size * size
    offs, masks = [], []
    for dr, dc in _DELTAS:
        m = np.zeros(n, dtype=bool)
        for r in range(size):
            cc_lo, cc_hi = max(0, -dc), min(size, size - dc)
            if 0 <= r + dr < size:
                m[r * size + cc_lo: r * size + cc_hi] = True
        offs.append(dr * size + dc)
        masks.append(m)
    return tuple(offs), np.stack(masks)


@functools.lru_cache(maxsize=None)
def _device_tables(size: int, device: torch.device):
    """The static tables as tensors on ``device`` (cached per size/device, so
    the hot path uploads nothing)."""
    nbr, top, bottom, left, right = _static_tables(size)
    offs, masks = _shift_tables(size)
    t = lambda a: torch.as_tensor(a, device=device)
    return {"nbr": t(nbr).long(), "top": t(top), "bottom": t(bottom),
            "left": t(left), "right": t(right), "offs": offs,
            "masks": t(masks)}


def empty_board(spec: HexSpec, device=None) -> torch.Tensor:
    device = torch.device("cuda") if device is None else torch.device(device)
    return torch.zeros(spec.n_cells, dtype=torch.int8, device=device)


def place(board: torch.Tensor, move, player) -> torch.Tensor:
    """Place `player`'s stone at flat index `move` (no legality check).

    Batched over leading axes: ``board`` (..., n), ``move`` and ``player``
    (...). Returns a new board. ``move`` must be a valid cell index — a
    negative index is not wrapped as a JAX ``.at[]`` would wrap it; callers
    that may hold the "no move" sentinel clamp it first.
    """
    dev = board.device
    mv = torch.as_tensor(move, device=dev).to(torch.int64)
    pl = torch.as_tensor(player, device=dev).to(torch.int8)
    lead = board.shape[:-1]
    return board.scatter(-1, mv.expand(lead)[..., None],
                         pl.expand(lead)[..., None])


def legal_mask(board: torch.Tensor) -> torch.Tensor:
    return board == EMPTY


def connected(board: torch.Tensor, player, spec: HexSpec) -> torch.Tensor:
    """True iff `player` has a chain between their two edges.

    Frontier flood-fill to a fixpoint over the neighbor table; the padded
    reach set (extra sentinel cell) keeps every gather in-bounds without
    branching. ``board`` may carry leading axes (``player`` broadcasts over
    them): the loop then runs to the fixpoint of the whole batch, which is
    every lane's own fixpoint.
    """
    tb = _device_tables(spec.size, board.device)
    nbr = tb["nbr"]
    player = torch.as_tensor(player, device=board.device).to(torch.int8)
    is_black = (player == BLACK)[..., None]
    mine = board == player[..., None]
    start = torch.where(is_black, tb["top"], tb["left"])
    goal = torch.where(is_black, tb["bottom"], tb["right"])

    reach = mine & start
    changed = bool(reach.any())
    while changed:
        padded = torch.nn.functional.pad(reach, (0, 1))
        # cell joins the reach-set if any neighbor is reached and it is ours
        nbr_reached = padded[..., nbr].any(dim=-1)
        new = reach | (nbr_reached & mine)
        changed = bool((new != reach).any())
        reach = new
    return (reach & goal).any(dim=-1)


def winner(board: torch.Tensor, spec: HexSpec) -> torch.Tensor:
    """Winner of a FILLED board (Hex theorem: exactly one exists).

    One flood-fill: if BLACK is not connected, WHITE is. Returns int8 in
    {1, 2}.

    CONTRACT: the board must be completely filled. On a partially filled
    board this silently returns the BLACK connectivity result (1 if black
    is connected else 2) — which is NOT "who is winning". Callers that
    cannot prove the board is filled must use `connected` or
    `winner_checked`.
    """
    black_wins = connected(board, BLACK, spec)
    return torch.where(black_wins, BLACK, WHITE).to(torch.int8)


def winner_checked(board: torch.Tensor, spec: HexSpec) -> torch.Tensor:
    """`winner` with an eager assertion of the filled-board contract (one
    host read: use it at boundaries, not inside the search hot loop)."""
    assert bool((board != EMPTY).all()), (
        "winner_checked: board is not completely filled — winner() is "
        "only defined on terminal boards (use `connected` instead)")
    return winner(board, spec)


# ------------------------------------------------- batched (W, cells) ops ----
def doubling_rounds(n_cells: int) -> int:
    """Fixed pointer-doubling round budget: ceil(log2(n_cells)) + 2.

    The hook-and-jump round below (scatter-min hooking + pointer jump)
    converges well inside this bound on random AND adversarial
    snake/comb/solid boards up to 25x25. The CUDA kernel runs exactly this
    many rounds with no runtime convergence check, so DO NOT tighten this
    budget without re-running the fixed-round tests at the larger sizes;
    the plain path early-exits at the batch fixpoint.
    """
    return int(math.ceil(math.log2(max(2, n_cells)))) + 2


def cc_labels_batch(stones: torch.Tensor, spec: HexSpec,
                    rounds: int | None = None) -> torch.Tensor:
    """Min-index connected-component labels by pointer doubling.

    stones: (W, n_cells) bool — per-lane membership mask (one player's
    stones). Returns (W, n_cells) int32 labels: cells of one connected
    component share the component's minimum cell index; non-member cells
    keep their own index.

    Each round:

      1. hook (gather):   m[i]    = min over same-stone closed nbhd of P
      2. hook (scatter):  P[P[i]] = min(P[P[i]], m[i])   — roots adopt the
                          best label their subtree has seen (the step that
                          makes convergence O(log n) instead of O(diameter))
      3. jump:            P[i]    = P[P[i]]              — pointer doubling

    Labels are monotone non-increasing ints, so the fixpoint exists and is
    the exact component-min labeling. ``rounds=None`` loops to the fixpoint
    of the whole batch (one host read per round); ``rounds=k`` runs a fixed
    count (the kernel-shaped variant).
    """
    nbr = _device_tables(spec.size, stones.device)["nbr"]      # (n, 6)
    W, n = stones.shape
    P = torch.arange(n, dtype=torch.int64, device=stones.device).expand(W, n)

    # same-stone adjacency, fixed across rounds: (W, n, 6)
    stones_pad = torch.nn.functional.pad(stones, (0, 1))
    ok = stones_pad[:, nbr] & stones[:, :, None]

    def one_round(P):
        P_pad = torch.nn.functional.pad(P, (0, 1), value=n)
        nbr_lbl = torch.where(ok, P_pad[:, nbr], n)              # (W, n, 6)
        m = torch.minimum(P, nbr_lbl.amin(dim=2))                # gather hook
        Q = P.scatter_reduce(1, P, m, "amin", include_self=True)  # scatter hook
        Q = torch.minimum(Q, m)
        return torch.gather(Q, 1, Q)                             # pointer jump

    if rounds is None:
        while True:
            Q = one_round(P)
            if not bool((Q != P).any()):
                break
            P = Q
    else:
        for _ in range(rounds):
            P = one_round(P)
    return P.to(torch.int32)


def connected_batch(boards: torch.Tensor, player, spec: HexSpec) -> torch.Tensor:
    """Batched `connected`: (W, n_cells) boards -> (W,) bool.

    ``player`` is a scalar or (W,) tensor. Evaluates the whole batch with
    one O(log n) pointer-doubling solve instead of W O(diameter)
    flood-fills.
    """
    tb = _device_tables(spec.size, boards.device)
    W, n = boards.shape
    player = torch.as_tensor(player, device=boards.device).to(torch.int8)
    player = player.expand(W)
    stones = boards == player[:, None]
    labels = cc_labels_batch(stones, spec).long()
    is_black = (player == BLACK)[:, None]
    start = torch.where(is_black, tb["top"][None], tb["left"][None])
    goal = torch.where(is_black, tb["bottom"][None], tb["right"][None])
    # mark the component roots touching the start edge, then test the goal
    src = stones & start
    mark = torch.zeros((W, n + 1), dtype=torch.bool, device=boards.device)
    mark.scatter_(1, torch.where(src, labels, n), True)
    reached = stones & goal & torch.gather(mark, 1, labels)
    return reached.any(dim=1)


def winner_flood_batch(boards: torch.Tensor, spec: HexSpec) -> torch.Tensor:
    """Batched `winner` by gather-free frontier flood fill.

    Same filled-board contract as `winner`. One reach set for all W lanes,
    dilated with the six static shifts of ``_shift_tables`` per step and
    ONE convergence check for the whole batch — O(board diameter) steps of
    very cheap boolean work, one host read per step. An independent
    formulation of the connectivity the pointer-doubling kernel solves:
    the port's tests and ``chip_smoke.py`` hold the kernel against it.
    """
    tb = _device_tables(spec.size, boards.device)
    offs, masks = tb["offs"], tb["masks"]
    mine = boards == BLACK
    reach = mine & tb["top"][None, :]
    changed = bool(reach.any())
    while changed:
        acc = reach
        for off, mk in zip(offs, masks):
            acc = acc | (torch.roll(reach, -off, dims=1) & mk[None, :])
        new = acc & mine
        changed = bool((new != reach).any())
        reach = new
    black_wins = (reach & tb["bottom"][None, :]).any(dim=1)
    return torch.where(black_wins, BLACK, WHITE).to(torch.int8)


def winner_batch(boards: torch.Tensor, spec: HexSpec) -> torch.Tensor:
    """Batched `winner`: (W, n_cells) FILLED boards -> (W,) int8 in {1, 2}.

    Same contract as `winner` (boards must be filled). Dispatches through
    ``kernels.ops.hex_winner`` — the pointer-doubling CUDA kernel for a
    tensor on the card, its plain version for a tensor on the CPU.
    """
    from repro_torch.kernels import ops  # function-level: kernels ref imports hex

    return ops.hex_winner(boards, spec.size)


def random_fill_batch(boards: torch.Tensor, to_move, keys: torch.Tensor,
                      spec: HexSpec) -> torch.Tensor:
    """Batched `random_fill`: fill W boards' empties in one fused pass.

    ``keys`` is a (W, 2) key batch; lane w consumes exactly the stream the
    scalar ``random_fill`` would with ``keys[w]`` (one uniform draw per
    cell).

    The stone a cell receives depends only on the PARITY of its rank among
    the empty cells (random order), so instead of materializing the order
    with an argsort the rank is counted directly (see
    ``game.empty_fill_ranks``): one (W, n, n) boolean compare-and-count,
    with the same index-tie-break a stable argsort would apply.
    """
    empties = boards == EMPTY
    rank = game_mod.empty_fill_ranks(boards, keys)
    fill_color = game_mod.parity_fill_colors(rank, to_move)
    return torch.where(empties, fill_color, boards)


def playout_batch(boards: torch.Tensor, to_move, keys: torch.Tensor,
                  spec: HexSpec) -> torch.Tensor:
    """W random playouts fused into one (W, cells) evaluation stage.

    ``kernels.ops.hex_playout``: on the card ONE kernel launch fills every
    board and solves its connectivity; on the CPU the fill (one sort-free
    parity pass, ``random_fill_batch``) and the winner (one batched
    connectivity solve). ``to_move`` is a scalar or (W,); both paths fill
    lane w exactly as ``random_fill_batch`` does with ``keys[w]``.
    """
    from repro_torch.kernels import ops  # function-level: kernels ref imports hex

    W = boards.shape[0]
    tm = torch.as_tensor(to_move, device=boards.device)
    if tm.dtype != torch.int32 or tm.shape != (W,):
        tm = tm.to(torch.int32).expand(W).contiguous()
    return ops.hex_playout(boards, tm, keys.contiguous(), spec.size)


def random_fill(board: torch.Tensor, to_move, key: torch.Tensor,
                spec: HexSpec) -> torch.Tensor:
    """Fill every empty cell with alternating stones in a random order.

    Equivalent to playing uniformly-random legal moves to the end of the game
    (the paper's playout policy). The width-1 case of ``random_fill_batch``
    (same noise stream, bit-identical board).
    """
    return random_fill_batch(board[None], to_move, key[None], spec)[0]


def playout(board: torch.Tensor, to_move, key: torch.Tensor,
            spec: HexSpec) -> torch.Tensor:
    """Run one random playout; return the winning player (int8 1|2).

    The width-1 case of ``playout_batch``. The genuinely-scalar formulation
    — per-lane flood-fill winner — survives as ``HexGame.playout_scalar``.
    """
    return playout_batch(board[None], to_move, key[None], spec)[0]


def playout_value(board: torch.Tensor, to_move, perspective,
                  key: torch.Tensor, spec: HexSpec) -> torch.Tensor:
    """Playout result as 1.0 if `perspective` wins else 0.0 (Hex never
    draws, so the value is always 0 or 1)."""
    w = playout(board, to_move, key, spec)
    p = torch.as_tensor(perspective, device=board.device).to(torch.int8)
    return (w == p).to(torch.float32)


def replay_moves(moves: torch.Tensor, n_moves, first_player,
                 spec: HexSpec) -> torch.Tensor:
    """Reconstruct a board from a move list — the shared masked-scatter
    (``game.replay_moves``) at Hex's board length; see its contract."""
    return game_mod.replay_moves(moves, n_moves, first_player, spec.n_cells)


# ------------------------------------------------------- the Game protocol ----
class HexGame(NamedTuple):
    """Hex through the batched ``Game`` protocol (``core/game.py``).

    Every method delegates to the module functions above. Hex never draws
    (Hex theorem) and a game ends only when the board fills.
    """

    size: int

    @property
    def n_cells(self) -> int:
        return self.size * self.size

    @property
    def n_actions(self) -> int:
        return self.n_cells  # a move is an empty cell

    @property
    def max_moves(self) -> int:
        return self.n_cells  # games end exactly when the board fills

    def init_board(self, device=None) -> torch.Tensor:
        return empty_board(self, device)

    def place(self, board, move, player) -> torch.Tensor:
        return place(board, move, player)

    def legal_mask(self, board) -> torch.Tensor:
        return legal_mask(board)

    def terminal_batch(self, boards) -> torch.Tensor:
        return ~(boards == EMPTY).any(dim=-1)

    def winner_batch(self, boards) -> torch.Tensor:
        return winner_batch(boards, self)

    def playout_batch(self, boards, to_move, keys) -> torch.Tensor:
        return playout_batch(boards, to_move, keys, self)

    def playout_scalar(self, board, to_move, key) -> torch.Tensor:
        # the per-lane oracle: batched fill stream at width 1, but the
        # WINNER via the scalar O(diameter) flood fill — an independent
        # connectivity formulation to hold the fused path against
        filled = random_fill(board, to_move, key, self)
        return winner(filled, self)

    def replay_moves(self, moves, n_moves, first_player) -> torch.Tensor:
        return replay_moves(moves, n_moves, first_player, self)

    def winner_probe(self, board) -> torch.Tensor:
        # PARTIAL boards welcome: ``connected_batch`` only needs a chain to
        # exist, not a full board. Hex never draws: outcomes are -1|1|2.
        c1 = connected_batch(board[None], BLACK, self)[0]
        c2 = connected_batch(board[None], WHITE, self)[0]
        one = torch.ones((), dtype=torch.int8, device=board.device)
        return torch.where(c1, one, torch.where(c2, 2 * one, -one))


game_mod.register_game("hex", HexGame)
