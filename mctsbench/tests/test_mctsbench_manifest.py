"""``BENCHMARK.json`` against the benchmark's contract, and every item it
names found by name."""

import json
import re

import pytest

from mctsbench.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def man():
    return Manifest(ROOT)


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(man):
    assert set(man.data) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(man.data["run_seconds"], int)
    assert 1 <= man.data["run_seconds"] <= 51


def test_command_and_paths(man):
    cmd, paths = man.data["command"], man.data["paths"]
    assert 1 <= len(cmd) <= 32 and all(text_ok(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    for w in cmd[1:]:
        if "/" in w:   # a file the command names lies under paths
            assert any(w.startswith(p + "/") for p in paths), w
            assert (ROOT / w).is_file()


def test_names_units_and_keys(man):
    d = man.data
    items = d["configs"] + d["workloads"] + d["end_to_end"] + d["per_layer"]
    for kind in ("configs", "workloads"):
        names = [x["name"] for x in d[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for x in items:
        assert NAME.match(x["name"]), x["name"]
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in d["paths"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and text_ok(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and text_ok(m["layer"])
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(man):
    cells = [w["name"] for w in man.data["workloads"]]
    assert "setup_s" in {m["name"] for m in man.data["end_to_end"]}
    for cell in cells:
        e2e = {m["name"] for m in man.metrics(cell, trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = man.metrics(cell, trace=True)
        assert per
        assert all(m["moves"] in e2e for m in per)
        assert any("mfu" in m["name"] for m in per)
    for m in man.data["per_layer"] + man.data["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_every_item_found_by_name(man):
    for w in man.data["workloads"]:
        params = man.workload_params(w["name"])
        assert (params["config"], params["traffic"]) == (w["config"],
                                                         w["traffic"])
        assert hasattr(man.module("traffic", params["kind"]), "Traffic")
        config = man.config(w["config"])
        assert {"game", "board_size", "n_workers"} <= set(config)
        for stage in man.named("costs", params["costs"]).values():
            assert callable(stage.work)
        for probe in man.named("probes", params["probes"]).values():
            assert probe.TARGET and probe.KERNEL and callable(probe.work)
    for m in man.data["end_to_end"] + man.data["per_layer"]:
        assert callable(man.module("metrics", m["name"]).read)


def test_configs_keep_the_published_sizes(man):
    files = {c["name"]: json.loads((ROOT / c["file"]).read_text())
             for c in man.data["configs"]}
    assert files["hex11"]["board_size"] == 11
    assert files["gomoku15"]["board_size"] == 15
    for c in man.data["configs"]:
        assert c["reduced"] == []
        assert files[c["name"]]["source"] == c["source"]


def test_layers_named_alike(man):
    by_layer = {}
    for m in man.data["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in man.data["per_layer"]}:
        assert layer in perf, layer


def test_check_fits_the_day(man):
    """A full check of 24 cells at this run length fits its 12 hours."""
    runs = 2 + 14 * 24
    need = runs * (man.data["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200
