"""Expansion: the lanes' (leaf, move) proposals sorted per member, one tree
row written per new node. Bytes: the proposals in, the new rows out; the
sort's comparisons, log2 W a lane, twice (key and index)."""

import math

from mctsbench.work import row_bytes


def work(c: dict):
    L, new = c["lane_iterations"], c["expansions"]
    ops = L * 2 * math.ceil(math.log2(max(2, c["lanes"]))) + 8 * new
    return L * 8 + new * row_bytes(c["n_cells"]), ops
