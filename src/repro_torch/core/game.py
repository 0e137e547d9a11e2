"""Batched ``Game`` protocol + registry — the game-agnostic seam.

Port of ``repro.core.game``. The search layers (``core/gscpm.py``,
``core/mcts.py``) consume ONLY the protocol below and never import a game
module directly.

A game is a small hashable NamedTuple (python-int fields only) exposing the
vectorized primitives the fused pipeline consumes:

===================  ========================================================
``n_cells``          board length; boards are ``(n_cells,)`` int8 tensors
``n_actions``        distinct move ids (== ``n_cells``: a move is a cell)
``max_moves``        longest possible game (bounds the descent path length)
``init_board()``     the empty root position
``place(b, mv, p)``  set cell ``mv`` to player ``p`` (no legality check);
                     batched over leading axes
``legal_mask(b)``    bool ``(..., n_cells)`` — all-False at TERMINAL positions,
                     which is what stops the search expanding past the end
                     of a game
``terminal_batch``   ``(W, n_cells) -> (W,) bool`` — no legal move remains
``playout_batch``    ``(boards, to_move, keys) -> (W,) int8`` values — one
                     fused (W, cells) evaluation of W random playouts
``playout_scalar``   the per-lane oracle twin (same RNG stream per lane;
                     bit-identical to one lane of ``playout_batch``)
``winner_batch``     terminal boards -> ``(W,)`` int8 outcomes
``replay_moves``     masked-scatter board reconstruction from a move list
``winner_probe``     ONE possibly-PARTIAL board -> int8 status: -1 ongoing,
                     0 draw, 1|2 the winner
===================  ========================================================

Conventions shared by every game (the search machinery assumes them):

- cells hold ``EMPTY`` (0) or a player id (1 | 2); players alternate
  ``p -> 3 - p``;
- playout/winner values are int8 in ``{0, 1, 2}``: the winning player id, or
  ``DRAW`` (0) for a drawn game — ``core/tree.backup_paths`` handles all
  three values;
- ``playout_batch`` consumes exactly one ``(n_cells,)`` uniform draw per
  lane key (the rank stream below), so scalar and batched paths are
  bit-identical.

Where the JAX package lifts a per-lane function over lanes with ``vmap``,
the port writes the batch axis out: ``place`` and ``legal_mask`` take any
leading axes.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import rng

EMPTY = 0
P1 = 1
P2 = 2
DRAW = 0  # playout value of a drawn game


# --------------------------------------------------------------- registry ----
_REGISTRY: dict[str, Callable[[int], Any]] = {}


def stamp_game_identity(cls):
    """Make a Game NamedTuple compare/hash by TYPE as well as fields.

    Plain NamedTuples compare as tuples, so two different games of one
    board size would be equal — and anything keyed by the game (a config, a
    cache of per-game state) would silently serve one game's entry to the
    other. Every registered game class gets stamped.
    """
    def __eq__(self, other):
        return type(other) is type(self) and tuple(self) == tuple(other)

    def __hash__(self):
        return hash((type(self).__qualname__, *self))

    cls.__eq__ = __eq__
    cls.__ne__ = lambda self, other: not __eq__(self, other)
    cls.__hash__ = __hash__
    return cls


def register_game(name: str, factory: Callable[[int], Any]) -> None:
    """Register ``factory(board_size) -> Game`` under ``name``."""
    if isinstance(factory, type) and issubclass(factory, tuple):
        stamp_game_identity(factory)
    _REGISTRY[name] = factory


def _ensure_builtin_games() -> None:
    # games self-register at import; lazy so game.py itself stays dep-free
    from repro_torch.core import gomoku, hex  # noqa: F401


def available_games() -> tuple[str, ...]:
    _ensure_builtin_games()
    return tuple(sorted(_REGISTRY))


def make_game(name: str, board_size: int):
    """Resolve a registered game — the ``--game`` flag's single entry point."""
    _ensure_builtin_games()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown game {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](board_size)


# ------------------------------------------------------ shared batched ops ----
def empty_fill_ranks(boards: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(W, n) rank of each cell among the lane's empties in random fill order.

    The shared core of every game's batched playout: lane w draws ONE
    ``(n,)`` uniform vector from ``keys[w]`` and the k-th smallest value
    over the empty cells marks the k-th playout move. The rank is counted
    directly — rank[i] = #{empty j : (noise_j, j) < (noise_i, i)} — one
    (W, n, n) boolean compare-and-count with the index tie-break a stable
    argsort would apply. With identical uniforms the count is
    integer-exact. Non-empty cells get a meaningless rank; callers mask
    them.
    """
    W, n = boards.shape
    empties = boards == EMPTY
    noise = rng.uniform(keys, n)                              # (W, n)
    idx = torch.arange(n, dtype=torch.int32, device=boards.device)
    nj, ni = noise[:, None, :], noise[:, :, None]
    earlier = (nj < ni) | ((nj == ni)
                           & (idx[None, None, :] < idx[None, :, None]))
    return (earlier & empties[:, None, :]).sum(dim=2, dtype=torch.int32)


def parity_fill_colors(ranks: torch.Tensor, to_move) -> torch.Tensor:
    """Stone colors of a random fill: rank parity alternates from ``to_move``."""
    W = ranks.shape[0]
    tm = torch.as_tensor(to_move, device=ranks.device).to(torch.int32)
    tm = tm.expand(W)[:, None]
    other = 3 - tm
    return torch.where((ranks % 2) == 0, tm, other).to(torch.int8)


def replay_moves(moves: torch.Tensor, n_moves, first_player,
                 n_cells: int) -> torch.Tensor:
    """Reconstruct a board from a move list (fixed-length, masked by n_moves).

    One masked scatter instead of a per-move loop: move i places the
    (i-even ? first : other) player's stone; moves at or past ``n_moves``
    land on a pad cell and are dropped. Moves must target distinct cells
    (every legal game's move list does — a move is an empty cell); the
    caller is responsible for the list not running past the game's end.
    """
    L = moves.shape[0]
    dev = moves.device
    idx = torch.arange(L, dtype=torch.int32, device=dev)
    first_player = torch.as_tensor(first_player, device=dev).to(torch.int32)
    players = torch.where((idx % 2) == 0, first_player,
                          3 - first_player).to(torch.int8)
    tgt = torch.where(idx < torch.as_tensor(n_moves, device=dev), moves,
                      n_cells)
    board = torch.zeros((n_cells + 1,), dtype=torch.int8, device=dev)
    board[tgt.long()] = players
    return board[:n_cells]
