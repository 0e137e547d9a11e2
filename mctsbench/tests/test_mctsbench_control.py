"""The control, the reference searched in bfloat16 in the program's place,
fails the comparison; the float32 reference in its place passes."""

import pytest

from bench_util import tiny_root
from mctsbench.control import readings


@pytest.mark.parametrize("game", ["hex", "gomoku"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_control_parts_every_checked_member(tmp_path, game, seed):
    root = tiny_root(tmp_path, game)
    r = readings("tiny.moves", seed, calls=2, root=root)
    assert r["checked_members"] == 8
    assert r["parted_members"] >= 6 and r["correct"] is False
