"""Render the roofline table from the port's dry-run artifacts (the twin
of ``benchmarks/roofline_table.py``).

Reads ``artifacts/dryrun_torch/*.json`` (written by
``python -m repro_torch.launch.dryrun``) and emits the per-(arch x shape)
markdown table of each mesh (one card, the single-pod and the multi-pod
mesh): the three terms with the H100's constants, the dominant
bottleneck, MODEL_FLOPS over counted FLOPs, peak GB a chip. The counts come from
``meta`` runs on the host: every term is a prediction from the data
sheet's peaks, not a measurement. Cells the dry-run could not count are
listed under the table with their reason.
"""

from __future__ import annotations

import glob
import json
import os

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                          "dryrun_torch")


def load_cells(dryrun_dir: str = DRYRUN_DIR) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def render(cells: list[dict], mesh: str = "card") -> str:
    rows = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "MFU | useful (6ND/counted) | peak GB |",
        "|------|-------|---------|--------|------------|------------|"
        "-----|----------------------|---------|",
    ]
    errors = []
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if "error" in c:
            errors.append(f"- {c['arch']} x {c['shape']}: {c['error']}")
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['bottleneck']} | {r['mfu']*100:.1f}% | "
            f"{r['useful_ratio']*100:.1f}% | "
            f"{c['memory']['peak_bytes_per_chip']/1e9:.2f} |")
    return "\n".join(rows + ([""] + errors if errors else []))


def run(dryrun_dir: str = DRYRUN_DIR) -> dict:
    cells = load_cells(dryrun_dir)
    ok = [c for c in cells if "error" not in c]
    return {
        "n_cells": len(cells),
        "n_ok": len(ok),
        "table_card": render(cells, "card"),
        "table_single": render(cells, "single"),
        "table_multipod": render(cells, "multipod"),
    }


if __name__ == "__main__":
    r = run()
    print(f"{r['n_ok']}/{r['n_cells']} cells\n")
    for mesh in ("card", "single", "multipod"):
        print(f"{mesh}:\n{r['table_' + mesh]}\n")
