"""Descent: every lane walks from its member's root to its leaf, scoring
each child of every node it passes (a uniform for the child's noise and a
UCT score) after a key fold a level.

The count takes the children of the node at level ``l`` as the root's empty
cells less ``l`` (a node is passed only when its children cover its board's
empty cells); with only the total and the deepest depth known, every lane
is charged the fewest root empties and the deepest level's discount, which
cannot exceed the children really scored. Bytes: each member's root board
and root row (its children's ids and statistics) once an iteration, each
lane's key, and each lane's path, leaf, depth, empty count and board out.
"""

from mctsbench.work import THREEFRY_OPS, UCT_OPS, UNIFORM_OPS


def work(c: dict):
    n, L, it = c["n_cells"], c["lane_iterations"], c["iterations"]
    levels = c["depth_sum"]
    slots = levels * max(0.0, c["root_empties_min"]
                         - (c["depth_max"] - 1) / 2)
    ops = slots * (UNIFORM_OPS + UCT_OPS) + levels * (THREEFRY_OPS + 10)
    roots = c["members"] * it
    n_bytes = (roots * (n + 16 * (c["root_empties_min"] + 1)) + L * 16
               + 4 * (levels + L) + L * (12 + n))
    return n_bytes, ops
