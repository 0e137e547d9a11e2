"""The descent kernel's work, counted at its dispatch point
(``repro_torch.kernels.ops.select_descent``) from what each call returns:
the tree rows it scored and passed (each read once), the root boards and
keys, the outputs, and per lane and level a key fold and, per child, a
uniform and a UCT score. Copied from ``chip_smoke.py``'s ``descent_work``
and extended to the member axis."""

import torch

from mctsbench.work import THREEFRY_OPS, UCT_OPS, UNIFORM_OPS

TARGET = "select_descent"
KERNEL = "select_descent_kernel"


def work(args, out):
    tree, root_board = args[0], args[1]
    paths, depths = out[0], out[1]
    if root_board.dim() == 1:
        root_board, paths, depths = root_board[None], paths[None], depths[None]
    E, W, D = paths.shape
    cap, n = tree.cap, root_board.shape[-1]
    cols = torch.arange(D, device=paths.device)
    deep = depths[..., None].long()
    member = (torch.arange(E, device=paths.device) * (cap + 1))[:, None, None]
    rows = (paths.long() + member)
    scored = torch.unique(rows[cols < deep])
    passed = torch.unique(rows[(cols >= 1) & (cols <= deep)])
    kids = tree.n_children.reshape(-1)[scored].long()
    tree_bytes = (16 + 16 * kids).sum() + 4 * passed.numel() + 4 * E * W
    n_bytes = (tree_bytes + E * n + 16 * E * W + E * W * (4 * D + 12 + n))
    N = (root_board == 0).sum(-1).long()[:, None]
    lv = depths.long()
    slots = (lv * N - lv * (lv - 1) // 2).sum()
    n_ops = slots * (UNIFORM_OPS + UCT_OPS) + lv.sum() * (THREEFRY_OPS + 10)
    return float(n_bytes), float(n_ops)
