"""Sequential UCT search (paper Fig 1) — oracle + Table II baseline.

Port of ``repro.core.mcts``. Single-worker, one-iteration-at-a-time.
Selection reuses the deterministic ``select_one`` primitive; expansion and
backup are written independently with scalar updates so the batched
dedup/scatter machinery in ``gscpm.py`` has a simple implementation to be
tested against (same RNG schedule ⇒ bit-identical trees). Game-agnostic
like the rest of the search stack: every game-specific step routes through
the batched ``Game`` protocol, and the scalar backup credits draws (playout
value 0) with 0.5 exactly as ``tree.backup_paths`` does.

The tree is updated in place. Every step reads the host (it is the
sequential baseline, not a fast path).
"""

from __future__ import annotations

import time

import torch

from repro_torch import rng
from repro_torch.core import game as game_mod
from repro_torch.core.gscpm import propose_move, select_one
from repro_torch.core.tree import NO_NODE, Tree, best_child, init_tree, root_value


def uct_iteration(tree: Tree, root_board: torch.Tensor, game,
                  cp: float, key: torch.Tensor) -> Tree:
    """One select→expand→playout→backup iteration (scalar updates)."""
    k_noise, k_move, k_po = rng.split(key, 3)
    path, depth, leaf, board, n_empty = select_one(
        tree, root_board, game, cp, k_noise, noise_scale=0.0)
    mv = int(propose_move(tree, leaf, board, game, k_move))
    leaf, depth = int(leaf), int(depth)
    cap = tree.cap
    expanding = mv >= 0

    # ---- scalar expansion (the lock-protected region in the paper) ----
    n_nodes = int(tree.n_nodes)
    did = expanding and n_nodes < cap
    mover = int(tree.to_move[leaf])
    if did:
        new = n_nodes
        tree.parent[new] = leaf
        tree.move[new] = mv
        tree.to_move[new] = 3 - mover
        tree.children[leaf, int(tree.n_children[leaf])] = new
        tree.n_children[leaf] += 1
        tree.n_nodes.add_(1)
        path[depth + 1] = new

    # ---- playout (the game's batched evaluation stage at width 1: same
    # fill RNG, per-game winner dispatch through kernels.ops) ----
    b2 = game.place(board, mv, mover) if expanding else board
    nxt = 3 - mover if expanding else mover
    dev = board.device
    w = game.playout_batch(
        b2[None], torch.tensor([nxt], dtype=torch.int32, device=dev),
        k_po[None])[0]

    # ---- scalar backup (the paper's atomic w_j / n_j walk) ----
    wv = int(w)
    for node in path[: depth + 2].tolist():
        if node == cap:
            continue
        # 1 if the mover-into-node won the playout, 0.5 on a draw (value 0)
        credit = 0.5 if wv == 0 else float(3 - int(tree.to_move[node]) == wv)
        tree.visits[node] += 1.0
        tree.wins[node] += credit
    return tree


def uct_search(board: torch.Tensor, to_move: int, n_playouts: int,
               key: torch.Tensor, *, board_size: int = 11, cp: float = 1.0,
               tree_cap: int = 1 << 15, game: str = "hex",
               device=None) -> tuple[Tree, dict]:
    """Sequential UCTSearch(r, m) with the same RNG schedule as GSCPM's
    task 0 (``fold_in(fold_in(key, 0), i)``) for oracle comparisons.

    ``device=None`` means ``torch.device("cuda")``.
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    g = game_mod.make_game(game, board_size)
    board = torch.as_tensor(board).to(device=device, dtype=torch.int8)
    key = key.to(device)
    tree = init_tree(tree_cap, g.n_actions, to_move, device=device)
    task_key = rng.fold_in(key, 0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(n_playouts):
        tree = uct_iteration(tree, board, g, float(cp),
                             rng.fold_in(task_key, i))
    sync()
    dt = time.perf_counter() - t0
    stats = {
        "time_s": dt,
        "playouts": n_playouts,
        "playouts_per_s": n_playouts / max(dt, 1e-9),
        "tree_nodes": int(tree.n_nodes),
        "root_value": float(root_value(tree)),
        "best_move": int(best_child(tree)),
    }
    return tree, stats
