"""The rules of Hex and free-style Gomoku in NumPy: the benchmark's own.

Boards are ``(..., n)`` int8 arrays over the ``size x size`` cells in row
order: 0 empty, 1 and 2 the players' stones. A move is the index of an
empty cell; player 1 moves first and players alternate.

- **Hex**: player 1 joins the top and bottom rows, player 2 the left and
  right columns. A cell (r, c) touches (r-1, c), (r-1, c+1), (r, c-1),
  (r, c+1), (r+1, c-1) and (r+1, c). A full board has exactly one winner,
  so a full board's winner is 1 exactly when player 1 joins its rows.
- **Gomoku** (free-style): five or more stones of one player in a row,
  column or diagonal win; a full board without five is a draw (0). No
  move is legal once a five stands.

A random playout fills the empty cells in the order of one uniform draw per
cell (the empty cell with the smallest number first, the lower index first
on equal numbers), the player to move placing first. Its value is the
winner, or 0 for a draw. In Gomoku the game ends at the first five: the
winner is the player whose five was completed first, and a five already on
the board has come before any cell of the fill.
"""

from __future__ import annotations

import numpy as np

from mctsbench.reference import threefry

EMPTY = 0


def fill_ranks(boards: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """(L, n) int32: each empty cell's place in the fill order of its board
    (0 first); -1 on stones already placed."""
    L, n = boards.shape
    u = threefry.uniform(keys, n)
    empty = boards == EMPTY
    order = np.argsort(np.where(empty, u, np.float32(2.0)), axis=1,
                       kind="stable")
    ranks = np.empty((L, n), dtype=np.int32)
    np.put_along_axis(ranks, order,
                      np.broadcast_to(np.arange(n, dtype=np.int32), (L, n)),
                      axis=1)
    return np.where(empty, ranks, -1)


def fill(boards: np.ndarray, to_move: np.ndarray, ranks: np.ndarray):
    """The boards after the fill: an even place gets the player to move's
    stone, an odd one the other player's."""
    tm = np.asarray(to_move, dtype=np.int8).reshape(-1, 1)
    colors = np.where(ranks % 2 == 0, tm, 3 - tm).astype(np.int8)
    return np.where(ranks >= 0, colors, boards).astype(np.int8)


class Hex:
    name = "hex"

    def __init__(self, size: int):
        self.size = size
        self.n_cells = size * size

    def legal(self, boards: np.ndarray) -> np.ndarray:
        return boards == EMPTY

    def joins_rows(self, boards: np.ndarray, player: int = 1) -> np.ndarray:
        """(L, n) -> (L,) bool: ``player``'s stones join the top and bottom
        rows (player 1's goal), by flooding from the top row."""
        s = self.size
        mine = (boards == player).reshape(-1, s, s)
        reach = np.zeros_like(mine)
        reach[:, 0, :] = mine[:, 0, :]
        while True:
            grow = reach.copy()
            grow[:, 1:, :] |= reach[:, :-1, :]
            grow[:, 1:, :-1] |= reach[:, :-1, 1:]
            grow[:, :, 1:] |= reach[:, :, :-1]
            grow[:, :, :-1] |= reach[:, :, 1:]
            grow[:, :-1, 1:] |= reach[:, 1:, :-1]
            grow[:, :-1, :] |= reach[:, 1:, :]
            grow &= mine
            if np.array_equal(grow, reach):
                return reach[:, -1, :].any(axis=1)
            reach = grow

    def winner_of_full(self, boards: np.ndarray) -> np.ndarray:
        return np.where(self.joins_rows(boards, 1), 1, 2).astype(np.int8)

    def playout(self, boards, to_move, keys) -> np.ndarray:
        ranks = fill_ranks(boards, keys)
        return self.winner_of_full(fill(boards, to_move, ranks))

    def has_winner(self, boards: np.ndarray) -> np.ndarray:
        """(L,) bool: a player already joins their sides."""
        s = self.size
        transposed = boards.reshape(-1, s, s).transpose(0, 2, 1).reshape(
            -1, self.n_cells)
        return self.joins_rows(boards, 1) | self.joins_rows(transposed, 2)


class Gomoku:
    name = "gomoku"
    run = 5

    def __init__(self, size: int):
        self.size = size
        self.n_cells = size * size
        s, k = size, self.run
        lines = []
        for r in range(s):
            for c in range(s):
                for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                    rr, cc = r + (k - 1) * dr, c + (k - 1) * dc
                    if 0 <= rr < s and 0 <= cc < s:
                        lines.append([(r + i * dr) * s + c + i * dc
                                      for i in range(k)])
        # (windows, 5) cell indices of every run of five cells
        self.windows = np.array(lines, dtype=np.int64).reshape(-1, k)

    def fives(self, boards: np.ndarray, player: int) -> np.ndarray:
        """(L, n) -> (L,) bool: ``player`` holds five in a row."""
        if not len(self.windows):
            return np.zeros(boards.shape[0], dtype=bool)
        return (boards[:, self.windows] == player).all(axis=2).any(axis=1)

    def has_winner(self, boards: np.ndarray) -> np.ndarray:
        return self.fives(boards, 1) | self.fives(boards, 2)

    def legal(self, boards: np.ndarray) -> np.ndarray:
        flat = boards.reshape(-1, self.n_cells)
        won = self.has_winner(flat)
        return ((flat == EMPTY) & ~won[:, None]).reshape(boards.shape)

    def playout(self, boards, to_move, keys) -> np.ndarray:
        ranks = fill_ranks(boards, keys)
        full = fill(boards, to_move, ranks)
        L = boards.shape[0]
        if not len(self.windows):
            return np.zeros(L, dtype=np.int8)
        never = np.int32(self.n_cells)
        # a five is complete when its last cell is placed
        done_at = ranks[:, self.windows].max(axis=2)
        first = []
        for player in (1, 2):
            mono = (full[:, self.windows] == player).all(axis=2)
            first.append(np.where(mono, done_at, never).min(axis=1))
        t1, t2 = first
        return np.where(t1 < t2, 1, np.where(t2 < t1, 2, 0)).astype(np.int8)


def make(name: str, size: int):
    games = {"hex": Hex, "gomoku": Gomoku}
    if name not in games:
        raise ValueError(f"unknown game {name!r}; known: {sorted(games)}")
    return games[name](size)
