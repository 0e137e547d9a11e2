"""Counting a search's work, and the least time the card could take for it.

Operations are counted per value the algorithm computes, whatever computes
it: a threefry-2x32 block is ``THREEFRY_OPS`` 32-bit integer operations (20
rounds of add, rotate and xor, 5 key injections), a uniform one block and
the float conversion, a UCT score ``UCT_OPS``. Bytes count each input read
once and each output written once. Where a count depends on the data and
only a total is known, the stage takes the bound that cannot exceed the
truth, so that a share of a peak is never counted too high.

``least_s`` is the roofline: the larger of the operations over the card's
float32/integer rate and the bytes over its memory rate (``peaks.json``).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

THREEFRY_OPS = 119
UNIFORM_OPS = THREEFRY_OPS + 4
UCT_OPS = 12
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(path: Path = PEAKS) -> dict:
    with open(path) as f:
        return json.load(f)


def least_s(n_bytes: float, n_ops: float, pk: dict) -> float:
    return max(n_bytes / pk["hbm_bytes_per_s"], n_ops / pk["ops_per_s"])


def doubling_rounds(n_cells: int) -> int:
    """Rounds of pointer doubling that label a Hex board's components:
    ceil(log2 n) + 2."""
    return math.ceil(math.log2(max(2, n_cells))) + 2


def row_bytes(n_cells: int) -> int:
    """Bytes of one tree node: parent, move, side to move and child count
    (4 each), visits, wins and virtual loss (4 each), one child id a move."""
    return 28 + 4 * n_cells


def kernel_roofline(obs: dict, probe: str):
    """A kernel's share of its roofline in %: the least time of the work
    probe ``probe`` counted, over the kernel's device time in the profiled
    call; None when either is missing."""
    tr, p = obs.get("trace"), obs.get("probes", {}).get(probe)
    if not tr or not p or not p["calls"]:
        return None
    t = tr.kernel_s(p["kernel"])
    if not t:
        return None
    return 100.0 * least_s(p["bytes"], p["ops"], obs["peaks"]) / t


def search_counts(summary: dict, boards, game: str, members: int,
                  lanes: int) -> dict:
    """The cost stages' inputs from the program's own counters of one call
    (``stats["metrics"]``, summed over members) and its root boards."""
    return {"game": game, "n_cells": boards.shape[1], "members": members,
            "lanes": lanes,
            "iterations": summary["sync_iterations"] // members,
            "lane_iterations": summary["lane_playouts"],
            "depth_sum": summary["depth_sum"],
            "depth_max": summary["depth_max"],
            "playout_cells": summary["playout_moves"],
            "expansions": summary["expansions"],
            "root_empties_min": int((boards == 0).sum(axis=1).min())}
