"""Shared benchmark harness utilities of the port's benchmarks.

``save_result`` and ``timed`` are the twins of ``benchmarks/common.py``'s;
``device_stamp`` names the card (and its power limit) every payload was
measured on, so no number is read as another device's.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

# the card's peak rates that bound a kernel's time: HBM3 bytes/s, float32
# and integer operations/s on the CUDA cores, bf16 operations/s on the
# tensor cores (H100 SXM)
from repro_torch.roofline.hw import (BF16_TENSOR_OPS_PER_S,  # noqa: F401
                                     HBM_BYTES_PER_S, OPS_PER_S)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                       "bench_torch")


def save_result(name: str, payload: dict) -> str:
    os.makedirs(ART_DIR, exist_ok=True)
    path = os.path.join(ART_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return os.path.abspath(path)


def timed(fn, *args, repeats: int = 1, **kw):
    """(min wall seconds, last result) over `repeats` calls."""
    best = float("inf")
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        best = min(best, time.perf_counter() - t0)
    return best, out


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU, as for every entry point of the port."""
    return torch.device("cuda") if device is None else torch.device(device)


def device_stamp(device=None):
    """``{"name", "power_limit"}`` of the card as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    current device's row), or ``"cpu"`` for a CPU run."""
    device = resolve_device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name, limit = (x.strip() for x in rows[index].split(",", 1))
    return {"name": name, "power_limit": limit}


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float = OPS_PER_S):
    """(least ms the card could take, "bytes" or "operations"): the bytes
    moved over the memory rate or the operations over ``ops_rate``,
    whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def ms_in_turns(fns: dict, device, iters: int = 50, rounds: int = 6,
                warmup: int = 5) -> dict:
    """Milliseconds per call of each function in ``fns``: batches of
    ``iters`` calls, the functions taken in turns (the order rotating each
    round) for ``rounds`` rounds, the median batch of each. On a GPU CUDA
    events time the batches; on the CPU the host clock does."""
    import statistics
    cuda = torch.device(device).type == "cuda"
    names = list(fns)
    for name in names:
        for _ in range(warmup):
            fns[name]()
    runs = {name: [] for name in names}
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
    for i in range(rounds):
        for name in names[i % len(names):] + names[:i % len(names)]:
            fn = fns[name]
            if cuda:
                start.record()
                for _ in range(iters):
                    fn()
                stop.record()
                torch.cuda.synchronize()
                runs[name].append(start.elapsed_time(stop) / iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                runs[name].append(1e3 * (time.perf_counter() - t0) / iters)
    return {name: statistics.median(r) for name, r in runs.items()}
