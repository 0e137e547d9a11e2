"""Root-parallel scaling — aggregate playouts/s vs ensemble size E, on the
port.

The torch twin of ``benchmarks/root_parallel.py``: E independent trees
advanced by ONE pass per sync iteration (one descent launch and one
playout launch for all E·W lanes on the card, no per-tree Python loop)
amortize the host's per-launch cost, so aggregate throughput grows with E
while a forest iteration costs about what a single tree's does.

The default per-tree config is the JAX twin's narrow one — each member a
W=1 searcher on 5x5, the setting of the paper's companion study
(arXiv:1409.4297) where an ensemble of sequential searchers is merged at
the root. On the card ``chip_smoke.py``'s forest runs 32-lane members on
11x11; ``run(n_workers=32, board_size=11, ...)`` measures that one.

Paired repeats, as in the JAX twin: each repeat times the single tree and
every ensemble size back to back and the speedup is the median of the
PAIRED ratios. The JAX twin's ``sharded_forest`` point (the forest
sharded over devices) belongs to the multi-card arm, which the port does
not have yet: the payload says so instead of measuring it.

    PYTHONPATH=src python -m benchmarks_torch.root_parallel
"""

from __future__ import annotations

import argparse
import json

from repro_torch import rng
from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
from repro_torch.core.root_parallel import gscpm_search_batch

from benchmarks_torch.common import device_stamp, resolve_device, save_result

MULTI_CARD = ("not measured: the multi-card forest is not ported yet "
              "(ROADMAP.md item A7, its multi-card row)")


def run(n_playouts: int = 4096, n_workers: int = 1, board_size: int = 5,
        n_tasks: int = 8, ensemble_sweep=(1, 2, 4, 8),
        merge_every: int = 0, seed: int = 0,
        tree_cap: int | None = None, repeats: int = 5,
        device=None) -> dict:
    device = resolve_device(device)
    cfg = GSCPMConfig(board_size=board_size, n_playouts=n_playouts,
                      n_tasks=n_tasks, n_workers=n_workers,
                      tree_cap=tree_cap or max(512, n_playouts // 8))
    board = cfg.game_obj.init_board(device)
    key = rng.key(seed, device)

    def one_single():
        _, st = gscpm_search(board, 1, cfg, key, device=device)
        return st

    def one_batch(e):
        _, st = gscpm_search_batch(board, 1, cfg, key, n_trees=e,
                                   merge_every=merge_every, device=device)
        return st

    # warm the allocator and every launch path before any timing
    one_single()
    for e in ensemble_sweep:
        one_batch(e)

    # paired repeats: shared hosts drift, so each rep measures the single
    # baseline and every ensemble size back to back and the speedup is the
    # median of PAIRED ratios
    single_rates = []
    batch_stats = {e: [] for e in ensemble_sweep}
    ratios = {e: [] for e in ensemble_sweep}
    for _ in range(repeats):
        s = one_single()
        single_rates.append(s["playouts_per_s"])
        for e in ensemble_sweep:
            st = one_batch(e)
            batch_stats[e].append(st)
            ratios[e].append(st["playouts_per_s"] / s["playouts_per_s"])

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    base_rate = median(single_rates)
    points = {}
    for e in ensemble_sweep:
        st = batch_stats[e][-1]
        speedup = median(ratios[e])
        points[str(e)] = {
            "playouts_per_s": median(
                [b["playouts_per_s"] for b in batch_stats[e]]),
            "aggregate_speedup": speedup,
            "batching_efficiency": speedup / e,
            "best_move_sum": st["best_move_sum"],
            "best_move_vote": st["best_move_vote"],
            "sharded": st["sharded"],
        }
    return {
        "device": device_stamp(device),
        "config": {"n_playouts": n_playouts, "n_workers": n_workers,
                   "board_size": board_size, "n_tasks": n_tasks,
                   "merge_every": merge_every, "repeats": repeats,
                   "n_devices": 1},
        "single_tree_playouts_per_s": base_rate,
        "single_tree_rates": single_rates,
        "ensemble": points,
        "sharded_forest": {"skipped": MULTI_CARD},
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true",
                   help="tiny budgets (a quick check that it runs)")
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda")
    args = p.parse_args(argv)
    out = (run(n_playouts=512, repeats=2, device=args.device) if args.smoke
           else run(device=args.device))
    base = out["single_tree_playouts_per_s"]
    print(f"single tree: {base:9.0f} playouts/s   (baseline)")
    for e, pt in out["ensemble"].items():
        print(f"E={e:>2} trees:  {pt['playouts_per_s']:9.0f} playouts/s   "
              f"aggregate {pt['aggregate_speedup']:5.2f}x   "
              f"batching efficiency {pt['batching_efficiency']:5.1%}")
    print(f"sharded forest: {out['sharded_forest']['skipped']}")
    print("->", save_result("root_parallel", out))
    return out


if __name__ == "__main__":
    main()
