"""Struct-of-arrays MCTS tree, fixed capacity, scatter-update friendly.

The paper keeps, per node, a preallocated vector of children plus atomic
counters (``w_j``, ``n_j``, child-allocation index). Here the tree is a
``NamedTuple`` of tensors with one PAD row (index == capacity) that absorbs
masked scatter writes; statistics are accumulated with ``index_add_``.

Port of the search half of ``repro.core.tree``. Every op indexes node axes
from the RIGHT (``shape[-1]``), so a leading ensemble axis stays legal for
the root-parallel forest layer.

**In-place updates.** The JAX package donates the tree's buffers to each
compiled chunk; the port's counterpart is that ``reset_vloss``,
``add_vloss`` and ``backup_paths`` (and the expansion in ``core.gscpm``)
write into the tensors they are given and return the same ``Tree``. A
caller that wants to keep the old state clones it first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NO_NODE = -1  # null child / parent sentinel


class Tree(NamedTuple):
    """MCTS tree with `cap` usable rows and one pad row at index `cap`.

    wins[j] is from the perspective of the player who MOVED INTO node j
    (i.e. ``3 - to_move[j]``), matching the UCT bookkeeping in the paper:
    X_j = w_j / n_j is the win rate child j offers its parent's mover.
    """

    parent: torch.Tensor      # (cap+1,) i32
    move: torch.Tensor        # (cap+1,) i32  move from parent that made this node
    to_move: torch.Tensor     # (cap+1,) i32  player to move at this node (1|2)
    children: torch.Tensor    # (cap+1, max_children) i32, NO_NODE padded
    n_children: torch.Tensor  # (cap+1,) i32
    visits: torch.Tensor      # (cap+1,) f32  n_j
    wins: torch.Tensor        # (cap+1,) f32  w_j
    vloss: torch.Tensor       # (cap+1,) f32  transient virtual-loss counts
    n_nodes: torch.Tensor     # ()      i32  allocation counter (the paper's atomic index)

    @property
    def cap(self) -> int:
        # shape[-1], not shape[0]: a forest (leading ensemble axis) must
        # report the same per-member capacity as a single tree
        return self.parent.shape[-1] - 1

    @property
    def max_children(self) -> int:
        return self.children.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.parent.device


def init_tree(cap: int, max_children: int, root_to_move, device=None) -> Tree:
    """Fresh tree containing only the root (node 0)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    to_move = torch.zeros((cap + 1,), **i32)
    to_move[0] = int(root_to_move)
    return Tree(
        parent=torch.full((cap + 1,), NO_NODE, **i32),
        move=torch.full((cap + 1,), NO_NODE, **i32),
        to_move=to_move,
        children=torch.full((cap + 1, max_children), NO_NODE, **i32),
        n_children=torch.zeros((cap + 1,), **i32),
        visits=torch.zeros((cap + 1,), **f32),
        wins=torch.zeros((cap + 1,), **f32),
        vloss=torch.zeros((cap + 1,), **f32),
        n_nodes=torch.ones((), **i32),
    )


def reset_vloss(tree: Tree) -> Tree:
    """Zero the virtual-loss counts (in place)."""
    tree.vloss.zero_()
    return tree


def backup_paths(tree: Tree, paths: torch.Tensor, values: torch.Tensor,
                 weights: torch.Tensor) -> Tree:
    """Batched backpropagation — the scatter-add analogue of atomic w_j/n_j.

    paths:   (W, max_depth) i32 node ids, PAD (== cap) where unused
    values:  (W,) playout outcomes: winning player (1|2) or 0 for a DRAW
    weights: (W,) f32 1.0 for active lanes, 0.0 for masked lanes

    Updates ``visits`` and ``wins`` in place. Every credit is 0, 0.5 or 1,
    so the float32 sums are exact up to 2**24 visits per node and do not
    depend on the order in which CUDA's atomic adds land: two runs give
    bit-identical trees.
    """
    W, D = paths.shape
    flat = paths.reshape(-1)
    # credit: 1 if the player who moved into the node won the playout,
    # 0.5 on a draw (keeps X_j = w_j / n_j in [0, 1] with 0.5 as the draw
    # point)
    mover = 3 - tree.to_move[flat]  # (W*D,)
    vals = values.to(torch.int32).repeat_interleave(D)
    win = torch.where(vals == 0, 0.5, (mover == vals).to(torch.float32))
    # mask pads & inactive lanes
    w = weights.repeat_interleave(D) * (flat != tree.cap)
    tree.visits.index_add_(0, flat, w)
    tree.wins.index_add_(0, flat, w * win)
    # pad row may have accumulated; zero it for hygiene
    tree.visits[tree.cap] = 0.0
    tree.wins[tree.cap] = 0.0
    return tree


def add_vloss(tree: Tree, paths: torch.Tensor, weights: torch.Tensor,
              amount: float = 1.0) -> Tree:
    """Scatter virtual loss along selected paths (in place; diversifies
    later rounds)."""
    W, D = paths.shape
    flat = paths.reshape(-1)
    w = weights.repeat_interleave(D) * (flat != tree.cap) * amount
    tree.vloss.index_add_(0, flat, w)
    tree.vloss[tree.cap] = 0.0
    return tree


def child_stat_tile(tree: Tree, nodes: torch.Tensor):
    """Gather the child statistics of a (W,) node batch as (W, C) tiles.

    Returns ``(safe, valid, wins, visits, vloss, parent_total)``: ``safe``
    holds child ids with invalid slots redirected to the PAD row (whose
    stats are all zero), ``valid`` masks real slots, and ``parent_total`` is
    each node's visits + virtual loss. This is the gather feeding one
    level-synchronous ``kernels.ops.uct_select`` call — all W lanes of a
    descent score one tree level in a single (W, C) tile.
    """
    C = tree.max_children
    cap = tree.cap
    slots = tree.children[nodes]                                   # (W, C)
    valid = (torch.arange(C, dtype=torch.int32, device=nodes.device)[None, :]
             < tree.n_children[nodes][:, None])
    safe = torch.where(valid, slots, cap)
    parent_total = tree.visits[nodes] + tree.vloss[nodes]          # (W,)
    return (safe, valid, tree.wins[safe], tree.visits[safe],
            tree.vloss[safe], parent_total)


def _root_children(tree: Tree):
    slots = tree.children[0]  # (max_children,)
    valid = (torch.arange(slots.shape[0], device=slots.device)
             < tree.n_children[0])
    return valid, torch.where(valid, slots, tree.cap)


def best_child(tree: Tree) -> torch.Tensor:
    """Most-visited root child's move (the paper's final move selection).

    Ties on the integer visit counts go to the first maximal slot, as
    ``argmax`` returns it.
    """
    valid, safe = _root_children(tree)
    counts = torch.where(valid, tree.visits[safe], -torch.inf)
    return tree.move[safe[torch.argmax(counts)]]


def root_value(tree: Tree) -> torch.Tensor:
    """Root win-rate estimate for the root's to-move player.

    wins[child] is from the mover-into-child = root's to-move perspective, so
    the root player's value is sum(child wins)/sum(child visits).
    """
    valid, safe = _root_children(tree)
    w = torch.where(valid, tree.wins[safe], 0.0).sum()
    n = torch.where(valid, tree.visits[safe], 0.0).sum()
    return w / torch.clamp(n, min=1.0)


def root_move_stats(tree: Tree, n_moves: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense per-move (visits, wins) of the root's children.

    Returns two (n_moves,) f32 tensors indexed by move id; moves without a
    root child are zero. This is the merge currency of root parallelism:
    per-member child *slots* are in discovery order, but per-move dense
    vectors add across ensemble members.
    """
    valid, safe = _root_children(tree)
    mv = torch.where(valid, tree.move[safe], n_moves)  # pad bucket == n_moves
    mv = torch.clamp(mv, 0, n_moves)
    zeros = torch.zeros((n_moves + 1,), dtype=torch.float32,
                        device=tree.device)
    visits = zeros.index_add(
        0, mv, torch.where(valid, tree.visits[safe], 0.0))[:n_moves]
    wins = zeros.index_add(
        0, mv, torch.where(valid, tree.wins[safe], 0.0))[:n_moves]
    return visits, wins


def root_summary(tree: Tree, n_moves: int,
                 reused_visits: int | None = None) -> dict:
    """Host-side snapshot of the root decision — "whatever stats the tree
    has now".

    Dense per-move visit/win vectors (``root_move_stats``), the
    most-visited move, and the root value, pulled to numpy. A tree with no
    root children yet reports ``best_move == NO_NODE`` (-1). Pass
    ``reused_visits`` (the root visit count the search started from) to
    expose how much of the evidence was inherited; it is reported only when
    present so cold-search snapshots stay bit-comparable across versions.
    """
    visits, wins = root_move_stats(tree, n_moves)
    out = {
        "root_visits": visits.cpu().numpy(),
        "root_wins": wins.cpu().numpy(),
        "best_move": int(best_child(tree)),
        "root_value": float(root_value(tree)),
        "tree_nodes": int(tree.n_nodes),
    }
    if reused_visits is not None:
        out["reused_visits"] = int(reused_visits)
    return out


# ------------------------------------------------------------ invariants ----
def check_invariants(tree: Tree, *, discrete_credits: bool = True) -> None:
    """Host-side structural invariant checks (used by the property tests).

    ``discrete_credits=True`` (board-game trees) additionally asserts the
    draw-aware credit structure: backups add 0, 0.5 (draw) or 1 win per
    visit, so accumulated wins are half-integers. The value-range check
    applies either way. No invariant equates root visits with the playout
    count — only the one-sided "children's visits never exceed the
    parent's" bound is asserted, so warm-started trees pass too.
    """
    t = Tree(*(x.detach().cpu().numpy() for x in tree))
    n = int(t.n_nodes)
    cap = tree.cap
    assert 1 <= n <= cap
    ids = np.arange(n)
    p = t.parent[1:n]
    assert ((p >= 0) & (p < n)).all(), "bad parent"
    assert (t.to_move[1:n] == 3 - t.to_move[p]).all(), \
        "to_move not alternating"
    k = t.n_children[:n]
    C = t.children.shape[1]
    live = np.arange(C)[None, :] < k[:, None]                 # (n, C)
    kids = t.children[:n]
    assert ((kids >= 0) & (kids < n))[live].all(), "invalid child ids"
    assert (kids[~live] == NO_NODE).all(), "stale child slots"
    safe = np.where(live, kids, cap)
    assert (t.parent[safe] == ids[:, None])[live].all(), "child parent mismatch"
    # child moves are distinct per node: sort each row, compare neighbours
    mv = np.where(live, t.move[safe], np.iinfo(np.int32).max)
    mv_s = np.sort(mv, axis=1)
    dup = (mv_s[:, 1:] == mv_s[:, :-1]) & (np.arange(1, C)[None, :] < k[:, None])
    assert not dup.any(), "duplicate child moves"
    # visits of children never exceed the parent's visits
    kid_visits = np.where(live, t.visits[safe], 0.0).sum(axis=1)
    assert (kid_visits <= t.visits[:n] + 1e-6).all()
    assert ((0.0 <= t.wins[:n]) & (t.wins[:n] <= t.visits[:n] + 1e-6)).all()
    if discrete_credits:
        w2 = 2.0 * t.wins[:n].astype(np.float64)
        assert (np.abs(w2 - np.round(w2)) < 1e-4).all(), \
            "wins not a half-integer credit sum"
    # every allocated non-root node is some node's child exactly once
    all_kids = np.sort(kids[live])
    assert np.array_equal(all_kids, np.arange(1, n)), \
        "child lists != allocated nodes"
