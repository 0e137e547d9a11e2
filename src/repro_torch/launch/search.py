"""Search launcher of the port: GSCPM self-play from the empty position.

``python -m repro_torch.launch.search --game hex --size 11 --workers 256``
runs a Grain-Size Controlled Parallel MCTS on the GPU and prints the chosen
move and throughput. ``--trees 8`` searches a root-parallel forest of 8
trees (``core.root_parallel.gscpm_search_batch``, visit-sum move);
``--moves 3`` plays three self-play moves, warm-starting each from the
re-rooted tree or forest (``--cold`` for a fresh one every move);
``--game gomoku`` searches free-style Gomoku. ``--device cpu`` runs the
same search with the kernels' plain PyTorch versions.

The flags are those of ``repro.launch.search``. ``--metrics`` threads the
device-side ``SearchMetrics`` counters through every search and prints
their summary (the moves are the same either way); ``--trace OUT.json``
records one ``gscpm_round`` span per schedule round, with the device
synchronised inside each, and a ``jit_compile`` instant for a build of
the CUDA kernels' library, and writes them as Chrome/Perfetto trace-event
JSON.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import rng
from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
from repro_torch.core.root_parallel import gscpm_search_batch
from repro_torch.core.tree import reroot_forest, reroot_tree
from repro_torch.obsv.trace import TraceRecorder, validate_trace


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
                   help="thread the device-side SearchMetrics accumulator "
                        "through the search and print its summary "
                        "(bit-identical results)")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="record per-round spans as Chrome/Perfetto trace-"
                        "event JSON (synchronises per round while tracing)")
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda (raises without a GPU)")
    args = p.parse_args(argv)

    device = "cuda" if args.device is None else args.device
    cfg = GSCPMConfig(game=args.game, board_size=args.size,
                      n_playouts=args.playouts, n_tasks=args.tasks,
                      n_workers=args.workers, cp=args.cp,
                      scheduler=args.scheduler,
                      tree_cap=max(1 << 14, 4 * args.playouts),
                      metrics=args.metrics)
    tracer = None
    if args.trace:
        tracer = TraceRecorder(process_name="repro-search")
        tracer.watch_compiles("kernels")    # builds of the CUDA library
    game = cfg.game_obj
    board = game.init_board(device)
    key = rng.key(args.seed, device)
    to_move = args.to_move
    carry = None    # the re-rooted tree/forest warm-starting the next move
    played = []
    for mvno in range(args.moves):
        key_mv = key if args.moves == 1 else rng.fold_in(key, mvno)
        reused = ""
        if args.trees > 1:
            forest, st = gscpm_search_batch(
                board, to_move, cfg, key_mv, n_trees=args.trees,
                forest=carry, tracer=tracer, device=device)
            mv = st["best_move_sum"]
            if "reused_nodes" in st:
                reused = f", reused {st['reused_nodes']} nodes"
            print(f"[{args.game} {args.size}x{args.size}] {st['n_trees']} "
                  f"trees, {st['playouts']} playouts in {st['time_s']:.2f}s "
                  f"({st['playouts_per_s']:.0f}/s, grain m={st['grain']}"
                  f"{reused}) on {device}")
            print(f"  best move (visit-sum) {st['best_move_sum']}, "
                  f"(majority vote) {st['best_move_vote']}; member values "
                  f"{['%.3f' % v for v in st['member_root_values']]}")
        else:
            tree, st = gscpm_search(board, to_move, cfg, key_mv,
                                    tree=carry, tracer=tracer, device=device)
            mv = st["best_move"]
            if "reused_visits" in st:
                reused = (f", reused {st['reused_nodes']} nodes / "
                          f"{st['reused_visits']:.0f} visits")
            print(f"[{args.game} {args.size}x{args.size}] {st['playouts']} "
                  f"playouts in {st['time_s']:.2f}s "
                  f"({st['playouts_per_s']:.0f}/s, grain m={st['grain']}, "
                  f"{st['tree_nodes']} nodes{reused}) on {device}")
            print(f"  best move {st['best_move']}, "
                  f"root value {st['root_value']:.3f}")
        if args.metrics:
            dm = st["metrics"]
            print(f"  device metrics: depth mean/max {dm['depth_mean']:.2f}/"
                  f"{dm['depth_max']}, {dm['expansions']} expansions "
                  f"({dm['expand_collision_rate']:.2f} collision rate), "
                  f"playout len mean/max {dm['playout_len_mean']:.1f}/"
                  f"{dm['playout_len_max']}, held levels {dm['held_levels']}, "
                  f"peak {dm['tree_nodes_peak']} nodes, "
                  f"reused {dm['tree_nodes_reused']}")
        played.append(mv)
        if mvno == args.moves - 1 or mv < 0:
            break
        if args.reuse:
            carry = (reroot_forest(forest, mv) if args.trees > 1
                     else reroot_tree(tree, mv))
        board = game.place(board, torch.tensor(mv, device=board.device),
                           to_move)
        to_move = 3 - to_move
    st["moves_played"] = played
    if tracer is not None:
        path = tracer.save(args.trace)
        st["trace_events"] = validate_trace(path)
        print(f"  trace: {st['trace_events']} events -> {path}")
    return st


if __name__ == "__main__":
    main()
