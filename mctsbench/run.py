"""Run one cell of the benchmark on the card this process finds.

    python3 mctsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the last lines of standard error are the numbers
the correctness check compared, each beside its limit. With no CUDA card,
or fewer cards than the cell asks for, or with a forbidden module (JAX or
the JAX package) loaded once the window has closed, it prints no result and
exits with a code other than 0.

Every build and kernel cache stays inside the checkout, at fixed paths
under ``build/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"REPRO_TORCH_BUILD_DIR": "build",
          "TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from mctsbench.device import missing_cards
    from mctsbench.harness import run_cell
    from mctsbench.manifest import Manifest

    chips = int(Manifest(ROOT).cell(args.workload)["chips"])
    why = missing_cards(torch, chips)
    if why:
        print(f"mctsbench: {why}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), root=ROOT, t0=T0)
    if result is None:
        return 3
    checks = result["checks"]
    print(json.dumps(result), flush=True)
    for k, v in checks.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
