"""Playout: a uniform a cell, each empty cell ranked among the board's
empty cells (three operations a pair), and the outcome: Hex labels the
filled board's components by pointer doubling (20 operations a cell a
round), Gomoku scans every five of both players and the time each was
completed (70 operations a cell). With only the total of empty cells
known, the pairs are counted as (sum E)^2 / lanes, which no set of boards
with that total undercuts. Bytes: board, side, key in, value out."""

from mctsbench.work import UNIFORM_OPS, doubling_rounds


def work(c: dict):
    n, L = c["n_cells"], c["lane_iterations"]
    pairs = c["playout_cells"] ** 2 / max(1, L)
    outcome = (n * doubling_rounds(n) * 20 if c["game"] == "hex"
               else 70 * n)
    ops = L * (n * UNIFORM_OPS + outcome) + 3 * pairs
    return L * (n + 4 + 16 + 1), ops
