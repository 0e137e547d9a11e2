"""Backup: every node on a lane's path, and its new node, gets a visit and
a win (two adds and the credit's test and select). A path holds the root,
one node a level and the new node when one was made for it; collapsed
proposals count once. Bytes: the new nodes' and the roots' statistics
written, each lane's value read."""


def work(c: dict):
    L, new = c["lane_iterations"], c["expansions"]
    nodes = c["depth_sum"] + L + new
    roots = c["members"] * c["iterations"]
    return 8 * (new + roots) + L, 4 * nodes
