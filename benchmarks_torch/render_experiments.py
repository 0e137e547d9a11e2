"""The sharded dry-run's summary and notes (the twin of
``benchmarks/render_experiments.py``).

Reads the port's dry-run cells (``artifacts/dryrun_torch/*.json``, written
by ``python -m repro_torch.launch.dryrun --all``) and renders what the
reference fills into its experiments write-up: how many of the 32 cells
were counted on the single-pod (16, 16) and multi-pod (2, 16, 16) meshes,
how many fit the H100's 80 GB a chip, the three largest peaks, the
single-pod roofline table (``roofline_table.render``) and its reading. The
counts come from ``meta`` runs on the host, one rank's share each: every
term is a prediction from the data sheet's peaks, not a measurement. The
reference's perf log (``artifacts/perf/``) has no counterpart here; the
card's measurements are ``chip_smoke.py``'s.
"""

from __future__ import annotations

from benchmarks_torch.roofline_table import DRYRUN_DIR, load_cells, render

HBM_GB = 80


def dryrun_summary(cells) -> str:
    ok = [c for c in cells if "error" not in c]
    single = [c for c in ok if c["mesh"] == "single"]
    multi = [c for c in ok if c["mesh"] == "multipod"]
    fits = sum(1 for c in single if c["memory"]["fits_hbm"])
    fits_multi = sum(1 for c in multi if c["memory"]["fits_hbm"])
    worst = sorted(single, key=lambda c: -c["memory"]["peak_bytes_per_chip"])
    lines = [
        f"- **{len(single)}/32 single-pod cells** counted on the 16×16 mesh; "
        f"**{len(multi)}/32 multi-pod cells** on 2×16×16 (the pod axis "
        "shards the batch; gradients are reduced across pods).",
        f"- {fits}/{len(single)} single-pod and {fits_multi}/{len(multi)} "
        f"multi-pod cells fit {HBM_GB} GB a chip at the baseline "
        "configuration; the largest single-pod peaks:",
    ]
    for c in worst[:3]:
        lines.append(
            f"  - {c['arch']} {c['shape']}: "
            f"{c['memory']['peak_bytes_per_chip'] / 1e9:.2f} GB"
            + (" (fits)" if c["memory"]["fits_hbm"] else " (over 80 GB)"))
    lines.append(
        "- per-cell JSON (memory breakdown, collective-by-op wire bytes, "
        "the sLSTM loop's trip counts, count times) in "
        "`artifacts/dryrun_torch/`.")
    return "\n".join(lines)


def roofline_notes(cells) -> str:
    single = [c for c in cells
              if c.get("mesh") == "single" and "error" not in c]
    n_mem = sum(1 for c in single if c["roofline"]["bottleneck"] == "memory")
    n_coll = sum(1 for c in single
                 if c["roofline"]["bottleneck"] == "collective")
    n_comp = len(single) - n_mem - n_coll
    return (f"Reading the table ({n_mem} memory-bound, {n_coll} "
            f"collective-bound, {n_comp} compute-bound single-pod cells; "
            "the collective term at NVLink's 450 GB/s, a lower bound: a "
            "16-wide axis spans two 8-GPU nodes):\n\n"
            "- decode cells read every (active) weight shard and their slice "
            "of the cache for one token a row: the memory term is the "
            "score, not MFU.\n"
            "- the wire breakdown (JSON `collectives.by_op`) names what "
            "crosses the links: the block edges' all-gathers of the "
            "sequence-split activations, the FSDP weight gathers, the MoE "
            "combine's all-reduce.\n"
            "- the `useful` column (6·N·D over the counted FLOPs) is below 1 "
            "by the attention FLOPs (reported apart), remat's recompute, and "
            "work replicated where a head count does not divide the 16-wide "
            "model axis (smollm's 9 heads, paligemma's 8).")


def run(dryrun_dir: str = DRYRUN_DIR) -> dict:
    cells = load_cells(dryrun_dir)
    return {
        "n_cells": len(cells),
        "n_ok": sum(1 for c in cells if "error" not in c),
        "dryrun_summary": dryrun_summary(cells),
        "roofline_table": render(cells, "single"),
        "roofline_notes": roofline_notes(cells),
    }


def main() -> None:
    r = run()
    print(r["dryrun_summary"], r["roofline_table"], r["roofline_notes"],
          sep="\n\n")


if __name__ == "__main__":
    main()
