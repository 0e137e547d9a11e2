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
PAIRED ratios. The ``sharded_forest`` point is the JAX twin's: the forest
sharded over an ensemble mesh against ``shard="off"``, both in one process
(the port's mesh is a list of devices, so no subprocess is needed): over
every visible card when the host has several, else over virtual shards of
the run's device. The two merged best moves must be equal and the sharded
run must report ``sharded``; both rates are reported. One thread
dispatches every shard, so on one card the sharded rate is a cost, not a
gain.

    PYTHONPATH=src python -m benchmarks_torch.root_parallel
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import rng
from repro_torch.core.gscpm import GSCPMConfig, gscpm_search
from repro_torch.core.root_parallel import gscpm_search_batch

from benchmarks_torch.common import device_stamp, resolve_device, save_result


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
        "sharded_forest": sharded_forest(
            n_playouts=min(n_playouts, 1024), repeats=2, device=device),
    }


def sharded_forest(n_playouts: int = 1024, n_trees: int = 8,
                   board_size: int = 5, n_tasks: int = 8,
                   n_workers: int = 1, tree_cap: int | None = None,
                   seed: int = 0, repeats: int = 3, n_devices: int = 8,
                   device=None) -> dict:
    """The forest sharded over an ensemble mesh against the one-device
    search, timed in turns (off, sharded, sharded, off, ...): the mesh is
    every visible card when the host has several and ``device`` is
    ``"cuda"`` (or None), else ``n_devices`` virtual shards of
    ``device``. The merged best move must agree (the bit-identity contract
    of tests/test_torch_forest_sharding.py, smoked on every run)."""
    device = resolve_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    devices = (None if cards > 1 and device.index is None
               else [device] * n_devices)
    cfg = GSCPMConfig(board_size=board_size, n_playouts=n_playouts,
                      n_tasks=n_tasks, n_workers=n_workers,
                      tree_cap=tree_cap or max(512, n_playouts // 8))
    board = cfg.game_obj.init_board(device)
    key = rng.key(seed, device)

    def one(shard):
        _, st = gscpm_search_batch(
            board, 1, cfg, key, n_trees=n_trees, shard=shard,
            device=device if shard == "off" else devices)
        return st

    one("off")                      # warm the allocator and every launch
    one("require")
    runs = {"off": [], "require": []}
    for rep_ in range(repeats):
        for shard in (("off", "require") if rep_ % 2 == 0
                      else ("require", "off")):
            runs[shard].append(one(shard))

    def point(stats):
        rates = sorted(s["playouts_per_s"] for s in stats)
        st = stats[-1]
        return {"sharded": st["sharded"], "n_devices": st["n_devices"],
                "mesh_shape": st["mesh_shape"],
                "padded_members": st["padded_members"],
                "playouts": st["playouts"],
                "playouts_per_s": rates[len(rates) // 2],
                "best_move_sum": st["best_move_sum"],
                "best_move_vote": st["best_move_vote"]}

    single, sharded = point(runs["off"]), point(runs["require"])
    assert sharded["sharded"] is True, "sharded point ran unsharded"
    assert single["sharded"] is False
    assert sharded["best_move_sum"] == single["best_move_sum"]
    assert sharded["playouts"] == single["playouts"]
    return {
        "config": {"n_playouts": n_playouts, "n_trees": n_trees,
                   "board_size": board_size, "n_tasks": n_tasks,
                   "n_workers": n_workers, "repeats": repeats,
                   "n_devices": sharded["n_devices"],
                   "virtual_shards": devices is not None},
        "single_device": single,
        "sharded": sharded,
        "speedup_vs_single_device": (sharded["playouts_per_s"]
                                     / max(single["playouts_per_s"], 1e-9)),
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
    sf = out["sharded_forest"]
    print(f"sharded forest over {sf['sharded']['n_devices']} shards: "
          f"{sf['sharded']['playouts_per_s']:9.0f} playouts/s against "
          f"{sf['single_device']['playouts_per_s']:9.0f} on one device "
          f"({sf['speedup_vs_single_device']:5.2f}x)")
    print("->", save_result("root_parallel", out))
    return out


if __name__ == "__main__":
    main()
