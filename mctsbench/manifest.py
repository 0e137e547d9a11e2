"""``BENCHMARK.json`` and the files it names, found by name under a root.

No list of cells, metrics, stages or probes lives in code: a cell is an
entry of the manifest plus ``workloads/<cell>.json``, which names its
traffic kind, cost stages and probes; every other item is a file of its own
in its folder (``mctsbench/__init__``'s text).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    """The manifest at ``root`` and the benchmark's folders beside it."""

    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.bench = self.root / HERE.name
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        known = [w["name"] for w in self.data["workloads"]]
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{known}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return read_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def workload_params(self, name: str) -> dict:
        return read_json(self.bench / "workloads" / f"{name}.json")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's metrics of one kind: ``end_to_end`` with tracing off,
        ``per_layer`` with it on; a metric with ``workloads`` only where it
        lists the cell."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def module(self, folder: str, name: str):
        """``<folder>/<name>.py`` of the benchmark, loaded by its path."""
        return load_module(self.bench / folder / f"{name}.py",
                           f"mctsbench_{folder}_{name}")

    def named(self, folder: str, names) -> dict:
        """``<folder>/<name>.py`` for each of ``names``, by name."""
        return {n: self.module(folder, n) for n in names}


def read_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod
