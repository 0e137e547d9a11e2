"""The Hex playout kernel's work, counted at its dispatch point
(``repro_torch.kernels.ops.hex_playout``) from the boards it is given:
boards, sides and keys in and winners out once; per board a uniform a
cell, three operations for each pair of its E empty cells, and the
labelling rounds. Copied from ``chip_smoke.py``'s ``playout_work``."""

from mctsbench.work import UNIFORM_OPS, doubling_rounds

TARGET = "hex_playout"
KERNEL = "hex_playout_kernel"


def work(args, out):
    boards = args[0]
    L, n = boards.shape
    empties = (boards == 0).sum(dim=1).double()
    n_bytes = L * n + 4 * L + 16 * L + L
    n_ops = (L * n * UNIFORM_OPS + float((3 * empties * empties).sum())
             + L * n * doubling_rounds(n) * 20)
    return float(n_bytes), float(n_ops)
