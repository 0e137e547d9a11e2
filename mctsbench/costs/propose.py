"""The lane's keys and the move proposal: a lane folds its iteration into
its task key and splits three keys (four threefry blocks), draws one
uniform a cell, masks the legal moves that have no child yet, and takes the
greatest. Gomoku's legal moves first ask whether a five stands (four
directions, five cells, two players). Bytes: the leaf board in, the move
out."""

from mctsbench.work import THREEFRY_OPS, UNIFORM_OPS


def work(c: dict):
    n, L = c["n_cells"], c["lane_iterations"]
    legal = 2 * 4 * 5 * n if c["game"] == "gomoku" else 0
    ops = L * (4 * THREEFRY_OPS + n * UNIFORM_OPS + 3 * n + legal)
    return L * (n + 4), ops
