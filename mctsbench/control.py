"""The readings of the correctness check's control: the reference run in
bfloat16 in the program's place, judged against the float32 reference.

    python3 mctsbench/control.py --workload <cell> --seeds 7,8,9 [--calls 4]

For each seed it takes the members a run of the cell checks when its window
holds ``--calls`` calls (the same traffic, positions, keys and kept
members, at the cell's own size), searches them with the float32 reference
and with the bfloat16 control, and prints one JSON line a seed with
``parted_members`` as the comparison reads it. A control that parts no
member would leave the comparison's limit without an upper reading. On a
CUDA card both searches take the card's float32 ``logf``; the program is
not run. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seed: int, calls: int, root=ROOT,
             device=None, workers: int = 1) -> dict:
    from mctsbench.harness import kept_members
    from mctsbench.manifest import Manifest
    from mctsbench.reference import compare, search

    man = Manifest(root)
    config = man.config(man.cell(workload)["config"])
    params = man.workload_params(workload)
    seed = int(seed) % 2**64
    traffic = man.module("traffic", params["kind"]).Traffic(params, config,
                                                            seed)
    picks = [(i, kept_members(seed, i, traffic.members))
             for i in range(calls)]
    log = search.card_log(device) if device else None
    out = {"workload": workload, "seed": seed}
    t = time.perf_counter()
    want = traffic.reference(picks, log=log, workers=workers)
    got = traffic.reference(picks, "bfloat16", log=log, workers=workers)
    checks, notes = compare.judge(got, want)
    out.update(checked_members=len(want),
               parted_members=checks["parted_members"]["value"],
               correct=compare.correct(checks, len(want)),
               seconds=time.perf_counter() - t, first_parting=notes[:1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from mctsbench.reference.search import reference_workers
    device = "cuda:0" if torch.cuda.is_available() else None
    for seed in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(seed), args.calls,
                                  device=device,
                                  workers=reference_workers())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
