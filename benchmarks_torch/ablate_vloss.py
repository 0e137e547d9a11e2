"""Ablation: virtual-loss rounds — the SPMD analogue of the paper's locks,
on the port.

The torch twin of ``benchmarks/ablate_vloss.py``. With W lanes selecting
against one tree snapshot, simultaneous selections collide (search
overhead — the phenomenon the paper handles with local locks + atomic
w/n; the JAX package maps it to virtual-loss rounds R). R=1 is maximally
parallel (most collisions); R=W degenerates toward sequential selection
(none). The ablation measures search QUALITY at a fixed playout budget:
tree size (diversity) and root-child coverage vs R, plus throughput cost
per round. Each round of a sync iteration is one ``select_descent``
launch on the card.

    PYTHONPATH=src python -m benchmarks_torch.ablate_vloss
"""

from __future__ import annotations

import json

from repro_torch import rng
from repro_torch.core import hex as hx
from repro_torch.core.gscpm import GSCPMConfig, gscpm_search

from benchmarks_torch.common import device_stamp, resolve_device, save_result


def run(n_playouts: int = 1024, n_workers: int = 16, board_size: int = 9,
        rounds=(1, 2, 4, 8), seed: int = 0, n_tasks: int = 64,
        tree_cap: int = 1 << 14, device=None) -> dict:
    device = resolve_device(device)
    board = hx.empty_board(hx.HexSpec(board_size), device)
    key = rng.key(seed, device)
    out = {}
    for r in rounds:
        cfg = GSCPMConfig(board_size=board_size, n_playouts=n_playouts,
                          n_tasks=n_tasks, n_workers=n_workers, vl_rounds=r,
                          tree_cap=tree_cap, scheduler="fifo")
        gscpm_search(board, 1, cfg, key, device=device)       # warm-up
        tree, st = gscpm_search(board, 1, cfg, key, device=device)
        out[str(r)] = {
            "tree_nodes": st["tree_nodes"],
            "root_children": int(tree.n_children[0]),
            "playouts_per_s": st["playouts_per_s"],
            "root_value": st["root_value"],
            "best_move": st["best_move"],
        }
    return {"device": device_stamp(device), "n_playouts": n_playouts,
            "n_workers": n_workers, "n_tasks": n_tasks,
            "board": f"{board_size}x{board_size}",
            "rounds": list(rounds), "results": out}


if __name__ == "__main__":
    r = run()
    print(json.dumps(r, indent=1))
    save_result("ablate_vloss", r)
