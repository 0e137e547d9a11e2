"""The card a run measures on. ``stamp`` is copied from
``benchmarks_torch/common.device_stamp``: the card's name and power limit as
``nvidia-smi`` reports them, so no number is read as another card's."""

from __future__ import annotations

import subprocess


def stamp(index: int = 0) -> dict:
    """``{"name", "power_limit"}`` of card ``index`` from ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``."""
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name, limit = (x.strip() for x in rows[index].split(",", 1))
    return {"name": name, "power_limit": limit}


def missing_cards(torch, chips: int) -> str | None:
    """Why this process cannot run a cell of ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures the card and never " \
               "falls back to the CPU"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} visible")
    return None
