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
