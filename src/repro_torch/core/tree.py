"""Struct-of-arrays MCTS tree, fixed capacity, scatter-update friendly.

The paper keeps, per node, a preallocated vector of children plus atomic
counters (``w_j``, ``n_j``, child-allocation index). Here the tree is a
``NamedTuple`` of tensors with one PAD row (index == capacity) that absorbs
masked scatter writes; statistics are accumulated with ``index_add_``.

Port of ``repro.core.tree``: the search half, the forest half and the
re-root half.

**Forests.** A forest is E independent trees stacked along a leading
ensemble axis: every field is ``(E, cap + 1[, C])`` and ``n_nodes`` is
``(E,)``. Node ids stay MEMBER-LOCAL everywhere (a path, a leaf, a child id
means a row of its own member), as ``jax.vmap`` over a single tree gives
them. The ops below take a single tree or a forest alike: the node axes are
indexed from the right (``shape[-1]``), and where an op scatters or gathers
it views the contiguous fields as ``E·(cap + 1)`` rows and offsets each
member's ids by ``e·(cap + 1)`` (``member_rows``), so one pass serves all E
members and every member's PAD row is zeroed. ``init_forest`` /
``forest_member`` / ``forest_size`` are the ensemble helpers; the
root-parallel search lives in ``repro_torch.core.root_parallel``.

**In-place updates.** The JAX package donates the tree's buffers to each
compiled chunk; the port's counterpart is that ``reset_vloss``,
``add_vloss`` and ``backup_paths`` (and the expansion in ``core.gscpm``)
write into the tensors they are given and return the same ``Tree``. A
caller that wants to keep the old state clones it first. Re-rooting
(``reroot_tree`` / ``reroot_forest``) is the exception: it returns fresh
tensors and leaves its source as it was.
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


def init_forest(n_trees: int, cap: int, max_children: int, root_to_move,
                device=None) -> Tree:
    """E fresh trees stacked along a leading ensemble axis.

    ``root_to_move`` is a scalar (shared by all members) or an (E,) vector
    (one independent root position per member, e.g. multi-request search).
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    tm = torch.as_tensor(root_to_move, device=device).to(torch.int32)
    tm = tm.expand(n_trees)
    one = init_tree(cap, max_children, 1, device=device)
    forest = Tree(*(t.expand(n_trees, *t.shape).clone() for t in one))
    forest.to_move[:, 0] = tm
    return forest


def forest_size(forest: Tree) -> int:
    """Number of ensemble members E (leading axis of every field)."""
    return forest.parent.shape[0]


def forest_member(forest: Tree, e: int) -> Tree:
    """Member ``e`` as a plain single tree: views of the forest's tensors,
    so a write into the member is a write into the forest."""
    return Tree(*(x[e] for x in forest))


def split_members(x, devices):
    """Split a forest — or anything with a leading member axis: a tensor, or
    a NamedTuple of them (``SearchMetrics``, ``RootSyncState``) — into
    ``len(devices)`` contiguous member blocks, block s on ``devices[s]``.

    Node ids are member-local, so a forest's block is a whole forest of its
    own (``member_rows`` offsets by the shard-local member index). Every
    block is a COPY with its own storage, even on the device the source
    lies on: a virtual shard must never be a view into a buffer
    another shard also writes, or a run on one device could pass where one
    over several cards fails. The member count must divide (pad first:
    ``root_parallel.pad_forest_members``)."""
    n = len(devices)
    if isinstance(x, torch.Tensor):
        E = x.shape[0]
        if E % n:
            raise ValueError(f"{E} members do not split into {n} shards")
        b = E // n
        return [x[s * b:(s + 1) * b].to(d, copy=True)
                for s, d in enumerate(devices)]
    parts = [split_members(f, devices) for f in x]
    return [type(x)(*fields) for fields in zip(*parts)]


def concat_members(shards, device):
    """The inverse of ``split_members``: the blocks concatenated in shard
    order into one structure on ``device`` (shard forests into one
    ``(E, cap + 1)`` forest)."""
    first = shards[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([s.to(device) for s in shards])
    return type(first)(*(concat_members(list(fs), device)
                         for fs in zip(*shards)))


def member_rows(tree: Tree, ids: torch.Tensor) -> torch.Tensor:
    """Member-local node ids -> rows of the flat ``E·(cap + 1)`` view.

    ``ids`` has the forest's member axis first (``(E, ...)``); for a single
    tree the ids are the rows and come back unchanged.
    """
    if tree.parent.dim() == 1:
        return ids
    E = tree.parent.shape[0]
    off = torch.arange(E, dtype=ids.dtype, device=ids.device) * (tree.cap + 1)
    return ids + off.view(E, *([1] * (ids.dim() - 1)))


def rows_view(tree: Tree, t: torch.Tensor) -> torch.Tensor:
    """A (cap + 1)-row field ``t`` of ``tree`` as ``E·(cap + 1)`` rows
    (``children`` keeps its slot axis). A view, so writes reach the tree:
    ``view`` raises rather than copy a field that is not contiguous."""
    return t.view(-1, *t.shape[tree.parent.dim():])


def gather_nodes(tree: Tree, t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``t[ids]`` for a field ``t`` of ``tree``, member by member on a
    forest (``ids`` member-local, member axis first)."""
    return rows_view(tree, t)[member_rows(tree, ids)]


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

    On a forest each argument gains the member axis first ((E, W, ...)),
    with member-local ids; all E members are updated in one scatter.

    Updates ``visits`` and ``wins`` in place. Every credit is 0, 0.5 or 1,
    so the float32 sums are exact up to 2**24 visits per node and do not
    depend on the order in which CUDA's atomic adds land: two runs give
    bit-identical trees.
    """
    D = paths.shape[-1]
    cap = tree.cap
    rows = member_rows(tree, paths).reshape(-1)
    pad = (paths == cap).reshape(-1)
    # credit: 1 if the player who moved into the node won the playout,
    # 0.5 on a draw (keeps X_j = w_j / n_j in [0, 1] with 0.5 as the draw
    # point)
    mover = 3 - rows_view(tree, tree.to_move)[rows]
    vals = values.reshape(-1).to(torch.int32).repeat_interleave(D)
    win = torch.where(vals == 0, 0.5, (mover == vals).to(torch.float32))
    # mask pads & inactive lanes
    w = weights.reshape(-1).repeat_interleave(D) * ~pad
    rows_view(tree, tree.visits).index_add_(0, rows, w)
    rows_view(tree, tree.wins).index_add_(0, rows, w * win)
    # pad rows may have accumulated; zero them for hygiene
    tree.visits[..., cap] = 0.0
    tree.wins[..., cap] = 0.0
    return tree


def add_vloss(tree: Tree, paths: torch.Tensor, weights: torch.Tensor,
              amount: float = 1.0) -> Tree:
    """Scatter virtual loss along selected paths (in place; diversifies
    later rounds). Shapes as ``backup_paths``'."""
    D = paths.shape[-1]
    rows = member_rows(tree, paths).reshape(-1)
    w = (weights.reshape(-1).repeat_interleave(D)
         * (paths != tree.cap).reshape(-1) * amount)
    rows_view(tree, tree.vloss).index_add_(0, rows, w)
    tree.vloss[..., tree.cap] = 0.0
    return tree


def child_stat_tile(tree: Tree, nodes: torch.Tensor):
    """Gather the child statistics of a (W,) node batch as (W, C) tiles.

    Returns ``(safe, valid, wins, visits, vloss, parent_total)``: ``safe``
    holds child ids with invalid slots redirected to the PAD row (whose
    stats are all zero), ``valid`` masks real slots, and ``parent_total`` is
    each node's visits + virtual loss. This is the gather feeding one
    level-synchronous ``kernels.ops.uct_select`` call — all W lanes of a
    descent score one tree level in a single (W, C) tile. On a forest
    ``nodes`` is (E, W) and every output gains the member axis; ``safe``
    stays member-local.
    """
    C = tree.max_children
    cap = tree.cap
    rows = member_rows(tree, nodes)
    slots = rows_view(tree, tree.children)[rows]                   # (W, C)
    valid = (torch.arange(C, dtype=torch.int32, device=nodes.device)
             < rows_view(tree, tree.n_children)[rows][..., None])
    safe = torch.where(valid, slots, cap)
    srows = member_rows(tree, safe)
    visits, vloss = rows_view(tree, tree.visits), rows_view(tree, tree.vloss)
    parent_total = visits[rows] + vloss[rows]                      # (W,)
    return (safe, valid, rows_view(tree, tree.wins)[srows], visits[srows],
            vloss[srows], parent_total)


def _root_children(tree: Tree):
    """(valid, safe) root-child slots, (C,) or (E, C) on a forest."""
    slots = tree.children[..., 0, :]
    valid = (torch.arange(slots.shape[-1], device=slots.device)
             < tree.n_children[..., 0, None])
    return valid, torch.where(valid, slots, tree.cap).long()


def best_child(tree: Tree) -> torch.Tensor:
    """Most-visited root child's move (the paper's final move selection);
    (E,) on a forest.

    Ties on the integer visit counts go to the first maximal slot, as
    ``argmax`` returns it.
    """
    valid, safe = _root_children(tree)
    counts = torch.where(valid, tree.visits.gather(-1, safe), -torch.inf)
    pick = torch.argmax(counts, dim=-1, keepdim=True)
    return tree.move.gather(-1, safe.gather(-1, pick))[..., 0]


def root_value(tree: Tree) -> torch.Tensor:
    """Root win-rate estimate for the root's to-move player; (E,) on a
    forest.

    wins[child] is from the mover-into-child = root's to-move perspective, so
    the root player's value is sum(child wins)/sum(child visits).
    """
    valid, safe = _root_children(tree)
    w = torch.where(valid, tree.wins.gather(-1, safe), 0.0).sum(-1)
    n = torch.where(valid, tree.visits.gather(-1, safe), 0.0).sum(-1)
    return w / torch.clamp(n, min=1.0)


def root_move_stats(tree: Tree, n_moves: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense per-move (visits, wins) of the root's children.

    Returns two (n_moves,) f32 tensors indexed by move id ((E, n_moves) on a
    forest); moves without a root child are zero. This is the merge currency
    of root parallelism: per-member child *slots* are in discovery order,
    but per-move dense vectors add across ensemble members.
    """
    valid, safe = _root_children(tree)
    mv = torch.where(valid, tree.move.gather(-1, safe), n_moves)  # pad bucket
    mv = torch.clamp(mv, 0, n_moves).long()
    zeros = torch.zeros((*mv.shape[:-1], n_moves + 1), dtype=torch.float32,
                        device=tree.device)
    # a root's child moves are distinct: each bucket gets one addend
    visits = zeros.scatter_add(
        -1, mv, torch.where(valid, tree.visits.gather(-1, safe), 0.0))
    wins = zeros.scatter_add(
        -1, mv, torch.where(valid, tree.wins.gather(-1, safe), 0.0))
    return visits[..., :n_moves], wins[..., :n_moves]


def root_summary(tree: Tree, n_moves: int,
                 reused_visits: int | None = None) -> dict:
    """Host-side snapshot of the root decision — "whatever stats the tree
    has now".

    Dense per-move visit/win vectors (``root_move_stats``), the
    most-visited move, and the root value, pulled to numpy. A tree with no
    root children yet reports ``best_move == NO_NODE`` (-1). Works
    unchanged on re-rooted trees, whose root carries retained evidence.
    Pass ``reused_visits`` (the root visit count the search started from)
    to expose how much of the evidence was inherited; it is reported only
    when present so cold-search snapshots stay bit-comparable across
    versions.
    """
    return materialize_root_summary(root_summary_device(tree, n_moves),
                                    reused_visits)


def root_summary_device(tree: Tree, n_moves: int) -> dict:
    """Device-side twin of ``root_summary``: the same reductions as tensors
    on the tree's device, nothing read back to the host (a serving engine
    reads them a tick later with ``materialize_root_summary``)."""
    visits, wins = root_move_stats(tree, n_moves)
    return {"root_visits": visits, "root_wins": wins,
            "best_move": best_child(tree), "root_value": root_value(tree),
            "tree_nodes": tree.n_nodes}


def materialize_root_summary(dev: dict,
                             reused_visits: int | None = None) -> dict:
    """Pull a ``root_summary_device`` dict to the exact host types
    ``root_summary`` ships."""
    out = {
        "root_visits": dev["root_visits"].cpu().numpy(),
        "root_wins": dev["root_wins"].cpu().numpy(),
        "best_move": int(dev["best_move"]),
        "root_value": float(dev["root_value"]),
        "tree_nodes": int(dev["tree_nodes"]),
    }
    if reused_visits is not None:
        out["reused_visits"] = int(reused_visits)
    return out


# -------------------------------------------------------------- re-rooting ----
def _reroot_impl(forest: Tree, moves: torch.Tensor, new_cap: int) -> Tree:
    """Re-root every member of an (E, cap + 1) forest at its root child
    carrying ``moves[e]``; returns a fresh (E, new_cap + 1) forest.

    The steps of the JAX package's ``_reroot_impl``, on all members at once
    (gathers along the node axis, ``dim=-1``):

    1. locate the root child that carries the move (may not exist);
    2. subtree membership by pointer doubling on the parent array — the
       old root and the played child become self-loops, so every allocated
       node's ancestor pointer converges to one of the two in
       ``ceil(log2(cap))`` gather rounds;
    3. per-node depth by the companion (ancestor, distance) doubling;
    4. BFS renumbering by one sort on the unique int64 key
       ``depth·(cap + 1) + old id``: parents sort strictly before children,
       so the new ids keep the ``parent[i] < i`` allocation order;
    5. one gather per field copies the retained rows into a fresh layout;
       non-retained rows source the old PAD row, whose fields are exactly
       the ``init_tree`` values.

    All of it is integer (the float fields are only copied), so the result
    equals the JAX package's field by field.
    """
    E = forest.parent.shape[0]
    cap = forest.cap
    C = forest.max_children
    dev = forest.parent.device
    i64 = dict(dtype=torch.int64, device=dev)
    idx = torch.arange(cap + 1, **i64)[None, :]
    n = forest.n_nodes.long()[:, None]
    alloc = idx < n                                             # (E, cap+1)

    # 1. the played child (old pad row when the move was never expanded)
    valid, safe = _root_children(forest)                        # (E, C)
    hit = valid & (forest.move.gather(1, safe) == moves.long()[:, None])
    first = torch.argmax(hit.to(torch.int32), dim=1, keepdim=True)
    child = torch.where(hit.any(1, keepdim=True), safe.gather(1, first), cap)

    # 2./3. membership and depth by pointer doubling
    rounds = max(1, int(cap + 1).bit_length())
    par = torch.where(alloc, forest.parent.long(), idx)   # unallocated: loop
    par = torch.where(idx == 0, 0, par)
    anc = torch.where(idx == child, idx, par)
    dist = ((idx != 0) & alloc).long()
    for _ in range(rounds):
        anc, dist, par = (anc.gather(1, anc), dist + dist.gather(1, par),
                          par.gather(1, par))
    member = alloc & (anc == child)
    n_sub = member.sum(1, keepdim=True)                         # (E, 1)

    # 4. BFS order: members by (depth, old id); non-members sink, by id
    sort_key = torch.where(member, dist, 1 << 30) * (cap + 1) + idx
    order = torch.argsort(sort_key, dim=1)
    rank = torch.arange(cap + 1, **i64)[None, :]
    is_m = rank < n_sub
    new_of_old = torch.full((E, cap + 1), new_cap, **i64).scatter_(
        1, torch.where(is_m, order, cap),
        torch.where(is_m, rank, new_cap).expand(E, -1).contiguous())

    # 5. gather rows into the fresh layout (new row k copies old row
    # order[k]; rows past the subtree copy the old PAD row == init state)
    kk = torch.arange(new_cap + 1, **i64)[None, :]
    take = kk < n_sub                                           # (E, new+1)
    src = torch.where(take, order.gather(
        1, torch.clamp(kk, max=cap).expand(E, -1)), cap)
    parent = torch.where(take, new_of_old.gather(
        1, torch.clamp(forest.parent.long().gather(1, src), 0, cap)), NO_NODE)
    parent[:, 0] = NO_NODE
    move = torch.where(take, forest.move.gather(1, src), NO_NODE)
    move[:, 0] = NO_NODE
    to_move = torch.where(take, forest.to_move.gather(1, src), 0)
    to_move[:, 0] = 3 - forest.to_move[:, 0]
    # children: one row gather, then old ids -> new ids through the flat
    # view of new_of_old (member offsets, int32 indices: no (E, new_cap+1,
    # C) int64 index tensor)
    src_rows = src + torch.arange(E, **i64)[:, None] * (cap + 1)
    ch_old = forest.children.view(-1, C)[src_rows]           # (E, new+1, C)
    off = (torch.arange(E, dtype=torch.int32, device=dev) * (cap + 1))
    ch_new = new_of_old.to(torch.int32).view(-1)[
        torch.clamp(ch_old, 0, cap) + off[:, None, None]]
    children = torch.where((ch_old >= 0) & take[..., None], ch_new, NO_NODE)
    i32 = lambda t: t.to(torch.int32)
    return Tree(
        parent=i32(parent), move=i32(move), to_move=i32(to_move),
        children=i32(children),
        n_children=torch.where(take, forest.n_children.gather(1, src), 0),
        visits=torch.where(take, forest.visits.gather(1, src), 0.0),
        wins=torch.where(take, forest.wins.gather(1, src), 0.0),
        vloss=torch.zeros((E, new_cap + 1), dtype=torch.float32, device=dev),
        n_nodes=i32(torch.clamp(n_sub[:, 0], min=1)),
    )


def _check_reroot_cap(cap: int, new_cap: int | None) -> int:
    if new_cap is None:
        return cap
    if new_cap < cap:
        # the retained subtree holds at most cap-1 nodes, so new_cap >= cap
        # always fits; anything smaller cannot be proven to fit from the
        # shapes alone — refuse loudly instead of silently truncating the
        # subtree (the stats-retention contract would be broken)
        raise ValueError(
            f"reroot capacity overflow risk: new_cap={new_cap} < "
            f"source cap={cap}; a re-rooted subtree can hold up to cap-1 "
            "nodes, so the fresh budget must be >= the source capacity "
            "(shrinking a tree would silently drop retained statistics)")
    return new_cap


def reroot_tree(tree: Tree, move, new_cap: int | None = None) -> Tree:
    """Re-root the tree at the root child carrying ``move`` (compaction).

    The played child's whole subtree is BFS-renumbered into a FRESH
    fixed-capacity tree whose node 0 is that child: the warm start of the
    next move's search. The source tree is not modified.

    Retention contract (asserted by ``check_reroot_retention``): every
    retained node's ``visits``/``wins``/``to_move``/``move``, its child
    COUNT and child set, and its depth (shifted by exactly -1) are
    bit-identical to the corresponding node of the source tree. Rows
    outside the subtree are indistinguishable from a fresh ``init_tree``'s.
    Virtual loss is transient per-search state and is cleared.

    Re-rooting onto a move the root never expanded yields a valid 1-node
    tree: root ``to_move`` flipped, zero statistics. ``new_cap`` (default:
    source capacity) must be >= the source capacity; smaller budgets raise
    ``ValueError``.
    """
    new_cap = _check_reroot_cap(tree.cap, new_cap)
    mv = torch.as_tensor(move, device=tree.device).to(torch.int32).reshape(1)
    one = _reroot_impl(Tree(*(t[None] for t in tree)), mv, new_cap)
    return Tree(*(t[0] for t in one))


def reroot_forest(forest: Tree, moves, new_cap: int | None = None) -> Tree:
    """``reroot_tree`` for all E members in one pass.

    ``moves`` is a scalar (every member re-roots at the same played move —
    the ensemble self-play case) or an (E,) vector (independent positions).
    Members that never expanded the move come back as 1-node trees.
    """
    new_cap = _check_reroot_cap(forest.cap, new_cap)
    E = forest_size(forest)
    mv = torch.as_tensor(moves, device=forest.device).to(torch.int32).expand(E)
    return _reroot_impl(forest, mv, new_cap)


def check_reroot_retention(src: Tree, dst: Tree, move: int) -> int:
    """Host-side assertion of the re-root retention contract; returns the
    number of retained nodes.

    Walks the source subtree under the played child and checks every node
    against its image in ``dst``: bit-identical ``visits``/``wins``,
    matching ``to_move``/``move``/child count, child moves as a set, and
    depth shifted by exactly one (O(subtree), host-side).
    """
    s = Tree(*(t.detach().cpu().numpy() for t in src))
    d = Tree(*(t.detach().cpu().numpy() for t in dst))
    kids0 = s.children[0][: int(s.n_children[0])]
    hits = [int(k) for k in kids0 if int(s.move[k]) == int(move)]
    if not hits:
        assert int(d.n_nodes) == 1, "unexpanded move must yield 1-node tree"
        assert d.visits[0] == 0.0 and d.wins[0] == 0.0
        assert int(d.to_move[0]) == 3 - int(s.to_move[0])
        return 0
    root = hits[0]
    sdep = node_depths(src)
    ddep = node_depths(dst)
    # BFS pairing: source subtree nodes in (depth, old id) order ARE the
    # destination nodes 0..n_sub-1 in id order (the renumbering's contract)
    members = []
    stack = [root]
    while stack:
        u = stack.pop()
        members.append(u)
        stack.extend(int(c) for c in s.children[u][: int(s.n_children[u])])
    members.sort(key=lambda u: (int(sdep[u]), u))
    n_sub = len(members)
    assert int(d.n_nodes) == n_sub, \
        f"retained {int(d.n_nodes)} nodes, subtree has {n_sub}"
    new_of_old = {u: k for k, u in enumerate(members)}
    for u, k in new_of_old.items():
        assert s.visits[u] == d.visits[k], f"visits differ at node {u}->{k}"
        assert s.wins[u] == d.wins[k], f"wins differ at node {u}->{k}"
        assert int(s.to_move[u]) == int(d.to_move[k])
        if k != 0:
            assert int(s.move[u]) == int(d.move[k])
            assert new_of_old[int(s.parent[u])] == int(d.parent[k])
        assert int(s.n_children[u]) == int(d.n_children[k])
        su = {int(new_of_old[int(c)])
              for c in s.children[u][: int(s.n_children[u])]}
        du = set(d.children[k][: int(d.n_children[k])].tolist())
        assert su == du, f"child set differs at node {u}->{k}"
        assert int(sdep[u]) == int(ddep[k]) + 1, "depth must shift by one"
    return n_sub


def node_depths(tree: Tree) -> np.ndarray:
    """Host-side per-node depth (root = 0); unallocated slots report -1.

    Walks parent pointers in allocation order — ``expand_batch`` only ever
    attaches new nodes to existing ones, so ``parent[i] < i`` and a single
    forward pass resolves every depth.
    """
    parent = tree.parent.detach().cpu().numpy()[:-1]   # drop the pad row
    n = int(tree.n_nodes)
    depth = np.full(parent.shape, -1, np.int64)
    if n > 0:
        depth[0] = 0
    for i in range(1, n):
        depth[i] = depth[parent[i]] + 1
    return depth


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
