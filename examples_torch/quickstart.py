"""Quickstart: Grain-Size Controlled Parallel MCTS on 9x9 Hex, on the port.

The torch twin of ``examples/quickstart.py``: a sequential UCT baseline,
then GSCPM at a sweep of grain sizes, printing the speedup curve (the Fig 7
shape: coarse grains starve the lanes, fine grains saturate them). Runs on
the GPU (its descent and playout are one CUDA kernel launch each);
``--device cpu`` runs the kernels' plain PyTorch versions.

    python examples_torch/quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import rng  # noqa: E402
from repro_torch.core import hex as hx  # noqa: E402
from repro_torch.core.gscpm import GSCPMConfig, gscpm_search  # noqa: E402
from repro_torch.core.mcts import uct_search  # noqa: E402

BOARD_SIZE, N_PLAYOUTS, N_WORKERS = 9, 1024, 16
TASK_SWEEP = (N_WORKERS, 64, 256)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    dev = p.parse_args(argv).device
    board = hx.empty_board(hx.HexSpec(BOARD_SIZE), dev)
    key = rng.key(0, dev)

    print(f"Hex {BOARD_SIZE}x{BOARD_SIZE}, {N_PLAYOUTS} playouts, "
          f"{N_WORKERS} lanes")
    uct_search(board, 1, 64, key, board_size=BOARD_SIZE, device=dev)  # warm-up
    _, seq = uct_search(board, 1, N_PLAYOUTS, key, board_size=BOARD_SIZE,
                        device=dev)
    print(f"sequential: {seq['playouts_per_s']:8.0f} playouts/s  "
          f"best move {seq['best_move']}  root value {seq['root_value']:.3f}")

    rows = []
    for n_tasks in TASK_SWEEP:
        cfg = GSCPMConfig(board_size=BOARD_SIZE, n_playouts=N_PLAYOUTS,
                          n_tasks=n_tasks, n_workers=N_WORKERS,
                          scheduler="fifo")
        gscpm_search(board, 1, cfg, key, device=dev)          # warm-up
        _, st = gscpm_search(board, 1, cfg, key, device=dev)
        label = ("one-task-per-lane" if n_tasks == N_WORKERS
                 else f"grain m={cfg.grain}")
        print(f"GSCPM nTasks={n_tasks:4d} ({label:17s}): "
              f"{st['playouts_per_s']:8.0f} playouts/s  "
              f"speedup {st['playouts_per_s']/seq['playouts_per_s']:5.2f}x  "
              f"best move {st['best_move']}")
        rows.append(st)
    return seq, rows


if __name__ == "__main__":
    main()
