"""Throwaway cells for the CPU tests: a copy of the benchmark in a
temporary root, with files and manifest entries added and none edited."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, game: str = "hex") -> Path:
    """A copy of ``BENCHMARK.json`` and ``mctsbench/`` under ``tmp`` plus a
    configuration ``tiny`` (``game`` on a 5x5 or 7x7 board, 8 lanes, 1,024
    nodes a tree) and a cell ``tiny.moves`` of 4 positions, 256 playouts and
    32 tasks each, listed for every per-layer metric."""
    shutil.copytree(ROOT / "mctsbench", tmp / "mctsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    base = "hex11" if game == "hex" else "gomoku15"
    cfg = json.loads((ROOT / f"mctsbench/configs/{base}.json").read_text())
    cfg.update(board_size=5 if game == "hex" else 7, n_workers=8,
               tree_cap=1024)
    add_file(tmp, "configs/tiny.json", cfg)
    add_file(tmp, "workloads/tiny.moves.json", {
        "config": "tiny", "traffic": "moves", "kind": "closed_batch",
        "members": 4, "opening_plies": [0, 6],
        "search": {"n_playouts": 256, "n_tasks": 32},
        "costs": ["descent", "propose", "expand", "playout", "backup"],
        "probes": ["select_descent", "hex_playout"]})
    m = json.loads((tmp / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny", "source": "a test's small board",
                         "file": "mctsbench/configs/tiny.json",
                         "reduced": ["board_size"], "why": "CPU test"})
    m["workloads"].append({"name": "tiny.moves", "config": "tiny",
                           "traffic": "moves", "chips": 1, "why": "test"})
    for metric in m["per_layer"]:
        metric.setdefault("workloads", []).append("tiny.moves")
    (tmp / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp


def add_file(root: Path, rel: str, content) -> Path:
    """Add ``mctsbench/<rel>`` (JSON for a dict, text otherwise); an
    existing file is an error: adding never edits."""
    path = root / "mctsbench" / rel
    if path.exists():
        raise FileExistsError(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(content) if isinstance(content, dict)
                    else content)
    return path
