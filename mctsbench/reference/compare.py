"""The comparison that decides ``correct``.

A member's answer is its tree's first ``n_nodes`` rows (parent, move,
visits, wins) and its best move. The program's answer to a checked request
is right when every one of those equals the reference's: node ids, moves and
parents are integers, and every visit and win is a sum of 0, 0.5 and 1, so
float32 holds them exactly and there is nothing to round.

The number compared is ``parted_members``: how many checked members'
answers differ in anything (a missing answer counts). Its limit is 0, an
exact comparison. A run that checks no member is not correct.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("parent", "move", "visits", "wins")
LIMIT = 0


def parted(got: dict, want: dict) -> str | None:
    """None when the answers agree, else where they first part."""
    if got["n_nodes"] != want["n_nodes"]:
        return f"n_nodes {got['n_nodes']} != {want['n_nodes']}"
    for f in FIELDS:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if not np.array_equal(a, b):
            return f"{f} first differs at node {int(np.argmax(a != b))}"
    if got["best_move"] != want["best_move"]:
        return f"best_move {got['best_move']} != {want['best_move']}"
    return None


def judge(got: list[dict], want: list[dict]):
    """(checks, notes): ``checks`` maps each number compared to its value
    and limit; ``notes`` says where each parted member parts."""
    notes = [p for p in (parted(g, w) for g, w in zip(got, want)) if p]
    if len(got) != len(want):
        notes.append(f"{len(got)} answers for {len(want)} checked members")
    checks = {"parted_members": {"value": len(notes), "limit": LIMIT}}
    return checks, notes


def correct(checks: dict, n_checked: int) -> bool:
    return n_checked > 0 and all(c["value"] <= c["limit"]
                                 for c in checks.values())
