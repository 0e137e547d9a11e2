"""Search launcher of the port: one GSCPM search, single tree, one move.

``python -m repro_torch.launch.search --game hex --size 11 --workers 256``
runs a Grain-Size Controlled Parallel MCTS from the empty position on the
GPU and prints the chosen move and throughput. ``--device cpu`` runs the
same search with the kernels' plain PyTorch versions.

The flags are those of ``repro.launch.search``. The ones whose machinery is
not ported yet are accepted and refused by name: ``--trees > 1`` (root
parallelism), ``--moves > 1`` (tree re-rooting between moves), ``--metrics``
and ``--trace`` (observability), ``--game gomoku``.
"""

from __future__ import annotations

import argparse

from repro_torch import rng
from repro_torch.core.gscpm import GSCPMConfig, gscpm_search


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--game", default="hex", choices=["hex", "gomoku"],
                   help="registered Game to search (core/game.py registry)")
    p.add_argument("--size", type=int, default=9, help="board side length")
    p.add_argument("--playouts", type=int, default=2048)
    p.add_argument("--tasks", type=int, default=64,
                   help="grain dial: m = playouts / tasks")
    p.add_argument("--workers", type=int, default=16, help="parallel lanes")
    p.add_argument("--trees", type=int, default=1,
                   help=">1: root-parallel ensemble of this many trees")
    p.add_argument("--scheduler", default="fifo",
                   choices=["fifo", "rebalance", "one_per_core",
                            "sequential"])
    p.add_argument("--cp", type=float, default=1.0)
    p.add_argument("--to-move", type=int, default=1, choices=[1, 2])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--moves", type=int, default=1,
                   help="play this many self-play moves (search, commit the "
                        "best move, re-root, repeat)")
    reuse = p.add_mutually_exclusive_group()
    reuse.add_argument("--reuse-tree", dest="reuse", action="store_true",
                       default=True,
                       help="warm-start each move from the re-rooted tree "
                            "(default)")
    reuse.add_argument("--cold", dest="reuse", action="store_false",
                       help="ablation: fresh tree every move")
    p.add_argument("--metrics", action="store_true",
                   help="device-side search counters")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="record per-round spans as trace-event JSON")
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda (raises without a GPU)")
    args = p.parse_args(argv)

    if args.trees > 1:
        raise NotImplementedError(
            "--trees > 1: the root-parallel forest is not ported yet "
            "(ROADMAP.md item A7: core/root_parallel.py)")
    if args.moves > 1:
        raise NotImplementedError(
            "--moves > 1: tree re-rooting between moves is not ported yet "
            "(ROADMAP.md item A8: core/tree.py reroot_tree)")
    if args.metrics:
        raise NotImplementedError(
            "--metrics: the device-side SearchMetrics counters are not "
            "ported yet (ROADMAP.md item A9: obsv/search_metrics.py)")
    if args.trace:
        raise NotImplementedError(
            "--trace: host-side tracing is not ported yet (ROADMAP.md item "
            "A9: obsv/trace.py)")

    device = "cuda" if args.device is None else args.device
    cfg = GSCPMConfig(game=args.game, board_size=args.size,
                      n_playouts=args.playouts, n_tasks=args.tasks,
                      n_workers=args.workers, cp=args.cp,
                      scheduler=args.scheduler,
                      tree_cap=max(1 << 14, 4 * args.playouts))
    board = cfg.game_obj.init_board(device)
    key = rng.key(args.seed, device)
    tree, st = gscpm_search(board, args.to_move, cfg, key, device=device)
    print(f"[{args.game} {args.size}x{args.size}] {st['playouts']} "
          f"playouts in {st['time_s']:.2f}s "
          f"({st['playouts_per_s']:.0f}/s, grain m={st['grain']}, "
          f"{st['tree_nodes']} nodes) on {device}")
    print(f"  best move {st['best_move']}, "
          f"root value {st['root_value']:.3f}")
    return st


if __name__ == "__main__":
    main()
