"""The benchmark's command on a card: a short run of each cell prints a
correct result line. Skips without a card."""

import json
import subprocess
import sys

import pytest

from mctsbench.manifest import ROOT, Manifest


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Manifest(ROOT).data["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, str(ROOT / "mctsbench/run.py"), "--workload", cell,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1] == "parted_members 0 limit 0"
