"""Paper Table II — sequential baseline time, on the port.

The paper: 1,048,576 playouts of 11x11 Hex, sequential, on Xeon CPU
(21.47 s) and Xeon Phi (185.37 s). Here: the port's sequential UCT search
(``repro_torch.core.mcts.uct_search``, one lane, a Python loop with host
reads at every level) on the given device at a scaled playout budget; we
report per-playout time and the extrapolated full-budget time. The
deliverable is the baseline every speedup of Fig 7/8 is measured against.

    PYTHONPATH=src python -m benchmarks_torch.table2_sequential
"""

from __future__ import annotations

import json

from repro_torch import rng
from repro_torch.configs.hex_paper import PAPER
from repro_torch.core import hex as hx
from repro_torch.core.mcts import uct_search

from benchmarks_torch.common import device_stamp, resolve_device, save_result


def run(n_playouts: int = 4096, board_size: int = 11, seed: int = 0,
        device=None) -> dict:
    device = resolve_device(device)
    board = hx.empty_board(hx.HexSpec(board_size), device)
    # warm-up game (paper: first game excluded — the allocator and the
    # first launches here)
    uct_search(board, 1, 64, rng.key(seed + 1, device), cp=PAPER.cp,
               tree_cap=1 << 14, board_size=board_size, device=device)
    tree, stats = uct_search(board, 1, n_playouts, rng.key(seed, device),
                             cp=PAPER.cp, board_size=board_size,
                             tree_cap=max(1 << 14, n_playouts * 2),
                             device=device)
    per_playout = stats["time_s"] / n_playouts
    return {
        "device": device_stamp(device),
        "board": f"{board_size}x{board_size}",
        "n_playouts": n_playouts,
        "time_s": stats["time_s"],
        "playouts_per_s": stats["playouts_per_s"],
        "per_playout_us": per_playout * 1e6,
        "extrapolated_paper_budget_s": per_playout * PAPER.n_playouts,
        "paper_xeon_s": 21.47,
        "paper_phi_s": 185.37,
        "tree_nodes": stats["tree_nodes"],
    }


if __name__ == "__main__":
    r = run()
    print(json.dumps(r, indent=1))
    save_result("table2_sequential", r)
