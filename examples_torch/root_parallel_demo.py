"""Root parallelism demo: an ensemble of trees searched as one forest, on
the port.

The torch twin of ``examples/root_parallel_demo.py``: a 7x7 Hex opening
searched by E independent GSCPM trees advanced by one pass per sync
iteration (on the GPU one descent launch and one playout launch for all
E·W lanes), each member's own move, the two merge disciplines' answers and
the aggregate throughput against the single-tree baseline; then again
with periodic root synchronization so members share discoveries
mid-search. ``--device cpu`` runs the kernels' plain PyTorch versions.
``--device`` takes a comma-separated list of devices to shard the forest's
members over (the single tree runs on the first): ``cuda:0,cuda:1`` over
two cards, ``cuda,cuda`` over two virtual shards of one, ``cpu,cpu,cpu``
on the CPU. Plain ``cuda`` on a host with several cards means all of them.

    python examples_torch/root_parallel_demo.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import rng  # noqa: E402
from repro_torch.core.gscpm import GSCPMConfig, gscpm_search  # noqa: E402
from repro_torch.core.root_parallel import gscpm_search_batch  # noqa: E402

# the classic root-parallel regime: each member is a NARROW searcher (few
# lanes); the ensemble axis carries the parallelism
BOARD_SIZE, N_PLAYOUTS, N_WORKERS, N_TREES = 7, 1024, 2, 8
N_TASKS, TREE_CAP = 16, 2048


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="a device, or a comma-separated list to shard over")
    devs = p.parse_args(argv).device.split(",")
    dev = devs[0]
    forest_dev = devs if len(devs) > 1 else dev
    cfg = GSCPMConfig(board_size=BOARD_SIZE, n_playouts=N_PLAYOUTS,
                      n_tasks=N_TASKS, n_workers=N_WORKERS,
                      tree_cap=TREE_CAP)
    board = cfg.game_obj.init_board(dev)
    key = rng.key(0, dev)

    print(f"Hex {BOARD_SIZE}x{BOARD_SIZE}, {N_PLAYOUTS} playouts/tree, "
          f"{N_WORKERS} lanes/tree, E={N_TREES} trees")

    gscpm_search(board, 1, cfg, key, device=dev)        # warm-up
    _, single = gscpm_search(board, 1, cfg, key, device=dev)
    print(f"single tree      : {single['playouts_per_s']:9.0f} playouts/s  "
          f"best move {single['best_move']}")

    out = {"single": single}
    for merge_every, label in ((0, "independent"), (2, "sync every 2 rounds")):
        gscpm_search_batch(board, 1, cfg, key, n_trees=N_TREES,
                           merge_every=merge_every,
                           device=forest_dev)  # warm-up
        _, st = gscpm_search_batch(board, 1, cfg, key, n_trees=N_TREES,
                                   merge_every=merge_every, device=forest_dev)
        where = (f", sharded over {st['n_devices']}" if st["sharded"]
                 else "")
        print(f"E={N_TREES} ({label:20s}): {st['playouts_per_s']:9.0f} "
              f"playouts/s  aggregate "
              f"{st['playouts_per_s'] / single['playouts_per_s']:5.2f}x"
              f"{where}")
        print(f"    member votes {st['member_best_moves']}")
        print(f"    visit-sum merge -> {st['best_move_sum']}   "
              f"majority vote -> {st['best_move_vote']}")
        out[merge_every] = st
    return out


if __name__ == "__main__":
    main()
