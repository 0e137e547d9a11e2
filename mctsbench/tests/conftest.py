"""The benchmark's own tests. ``card`` marks a test that needs a CUDA card:
it skips without one, decided inside the ``card`` fixture and never while a
module is imported. Run them with ``python -m pytest mctsbench/tests``; the
card tests run on a machine with a card by the same command."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips here with the reason")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on a card")
    return "cuda:0"
