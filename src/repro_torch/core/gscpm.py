"""GSCPM — Grain-Size Controlled Parallel MCTS (paper Fig 4), PyTorch port.

The paper splits ``nPlayouts`` UCT iterations into ``nTasks`` tasks of grain
``m = nPlayouts / nTasks`` and schedules them on a thread pool against one
shared tree. Here:

- a *lane* (one row of every (W, ...) tensor) plays the role of a hardware
  thread;
- a *task* is an ``m``-iteration chunk of batch-synchronous iterations;
- a *sync iteration* selects W leaves (in ``vl_rounds`` virtual-loss rounds)
  via a batched descent — ``kernels.ops.select_descent``: on the card one
  kernel launch per round in which every lane walks to its leaf, on the
  CPU the lockstep level loop with one ``kernels.ops.uct_select`` (W, C)
  tile per level — then dedup-expands the proposed (leaf, move) pairs with
  prefix-sum slot allocation (the paper's atomic child index), evaluates W
  playouts as ONE fused (W, cells) stage through the game's batched
  playout primitive (``game.playout_batch`` — for Hex one launch of
  ``kernels.ops.hex_playout`` on the card: fill and connectivity together)
  — and scatter-adds the results along the W paths (the paper's atomic
  w_j/n_j);
- per-task RNG streams come from ``rng.fold_in`` (the paper's per-task MKL
  streams).

Port of ``repro.core.gscpm``, same public names. What differs in idiom:

- PyTorch runs eagerly, so nothing is compiled per config; ``m``, ``cp``
  and the budgets are plain run-time values and sweeping them can change
  no code path.
- The JAX package donates the tree's buffers to each compiled chunk. The
  port updates the tree IN PLACE: ``expand_batch``, ``sync_iteration``,
  ``run_chunk``, ``run_schedule_round`` and ``gscpm_search(tree=...)`` write
  into the tensors of the tree they are given and return the same ``Tree``.
- On the card a sync iteration reads nothing back to the host: the descent
  kernel runs every lane to its leaf in one launch. The plain level loop
  (the CPU's path, and the card's inside ``kernels.ops.plain_versions()``)
  reads the host once per level to know when every lane is done.
- Where the JAX package lifts a per-lane function with ``vmap``, the batch
  axis is written out (``propose_move`` takes leading axes; the scalar
  oracles are Python loops over lanes). Its ``jax.vmap`` over the trees
  of a root-parallel forest is a leading member axis on every stage
  (``select_batch``, ``propose_move``, ``expand_batch``, the playout,
  ``tree.backup_paths``), so ``sync_iteration`` advances a whole forest in
  one pass (``core.root_parallel``).

This module is game-agnostic: every game-specific computation routes
through the batched ``Game`` protocol (``repro_torch.core.game``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import torch

from repro_torch import rng
from repro_torch.core import game as game_mod
from repro_torch.core import scheduler as sched
from repro_torch.core import uct as uct_mod
from repro_torch.core.game import EMPTY
from repro_torch.core.tree import (
    NO_NODE,
    Tree,
    add_vloss,
    backup_paths,
    best_child,
    child_stat_tile,
    forest_member,
    gather_nodes,
    init_tree,
    member_rows,
    reset_vloss,
    root_value,
    rows_view,
)
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class GSCPMConfig:
    """Knobs of the paper's experiment grid.

    Fields marked compare=False are excluded from the config's hash/eq, as
    in the JAX package (where they are the knobs that never reach a
    compiled program's shape): ``cp`` and the budget knobs
    ``n_playouts``/``n_tasks``/``scheduler`` only shape the host-side task
    schedule, so configs differing only in them name one search class.
    """

    game: str = "hex"               # Game-registry name (core/game.py)
    board_size: int = 11
    # paper: 1,048,576 playouts
    n_playouts: int = dataclasses.field(default=4096, compare=False)
    # the grain dial: m = n_playouts / n_tasks
    n_tasks: int = dataclasses.field(default=64, compare=False)
    n_workers: int = 16             # parallel lanes (hardware-thread analogue)
    vl_rounds: int = 1              # virtual-loss rounds per sync iteration
    virtual_loss: float = 1.0
    cp: float = dataclasses.field(default=1.0, compare=False)  # paper: Cp = 1.0
    select_noise: float = 1e-3      # per-lane UCT tie-break jitter
    tree_cap: int = 1 << 15
    # fifo | rebalance | one_per_core | sequential
    scheduler: str = dataclasses.field(default="fifo", compare=False)
    descent: str = "batched"        # batched (level-synchronous) | scalar (oracle)
    playout: str = "batched"        # batched (fused (W, cells)) | scalar (oracle)
    # device-side search counters: not ported yet (ROADMAP.md item A9)
    metrics: bool = False
    # root-parallel ensemble width: a serving-class key, as in the JAX
    # package; the forest search is core.root_parallel.gscpm_search_batch
    n_trees: int = 1

    @property
    def game_obj(self):
        """The resolved Game instance (hashable)."""
        return game_mod.make_game(self.game, self.board_size)

    @property
    def grain(self) -> int:
        return max(1, self.n_playouts // max(1, self.n_tasks))


def _check_in_slice(cfg: GSCPMConfig, tracer=None, metrics=None) -> None:
    """Refuse what the reference's signature offers but the port lacks."""
    if cfg.metrics or metrics is not None:
        raise NotImplementedError(
            "cfg.metrics / metrics=: the device-side SearchMetrics counters "
            "are not ported yet (ROADMAP.md item A9: obsv/search_metrics.py)")
    if tracer is not None:
        raise NotImplementedError(
            "tracer=: host-side tracing is not ported yet (ROADMAP.md item "
            "A9: obsv/trace.py)")


# ------------------------------------------------------------- selection ----
def select_one(tree: Tree, root_board: torch.Tensor, game, cp: float,
               noise_key: torch.Tensor, noise_scale: float):
    """Descend from the root to a not-fully-expanded (or terminal) node.

    Returns (path, depth, leaf, board_at_leaf, n_empty_at_leaf). ``path`` is
    (max_depth,) int32 padded with the tree's PAD row index. A node counts
    as fully expanded only when its children cover every EMPTY cell; games
    that end mid-board never get there — their terminal nodes keep zero
    children because ``game.legal_mask`` is empty, so the descent stops at
    them without a per-level terminal test.

    The per-lane oracle: a Python loop with host reads at every level.
    """
    max_depth = game.max_moves + 1
    cap = tree.cap
    C = tree.max_children
    dev = root_board.device

    path = torch.full((max_depth,), cap, dtype=torch.int32, device=dev)
    path[0] = 0
    n_empty = int((root_board == EMPTY).sum())
    node, depth, board = 0, 0, root_board
    slot_ids = torch.arange(C, dtype=torch.int32, device=dev)

    while True:
        n_kids = int(tree.n_children[node])
        fully = n_kids == n_empty and n_empty != 0
        if not (fully and depth < max_depth - 2):
            break
        # score children
        slots = tree.children[node]  # (C,)
        valid = slot_ids < n_kids
        safe = torch.where(valid, slots, cap)
        scores = uct_mod.uct_scores(
            tree.wins[safe], tree.visits[safe], tree.vloss[safe],
            tree.visits[node] + tree.vloss[node], cp, valid)
        noise = None
        if noise_scale > 0.0:
            noise = noise_scale * rng.uniform(
                rng.fold_in(noise_key, depth), C)
        pick = uct_mod.select_child(scores, noise)
        child = int(safe[pick])
        board = game.place(board, tree.move[child], tree.to_move[node])
        node, depth, n_empty = child, depth + 1, n_empty - 1
        path[depth] = child

    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return path, i32(depth), i32(node), board, i32(n_empty)


def level_noise(noise_keys: torch.Tensor, depths: torch.Tensor, n_slots: int,
                scale: float) -> torch.Tensor:
    """(W, C) tie-break noise for one descent level.

    Lane w draws from ``fold_in(noise_keys[w], depths[w])`` — exactly the
    stream the scalar per-lane oracle consumes at that depth, which is what
    makes the lockstep descent bit-identical to it.
    """
    return scale * rng.uniform(rng.fold_in(noise_keys, depths), n_slots)


def advance_paths(paths: torch.Tensor, depths: torch.Tensor,
                  child: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Write each stepping lane's chosen child at path level depth + 1
    (batched over leading axes)."""
    D = paths.shape[-1]
    cols = torch.arange(D, device=paths.device)
    return torch.where((cols == (depths + 1)[..., None]) & step[..., None],
                       child[..., None], paths)


def select_levels(tree: Tree, root_board: torch.Tensor, game, cp,
                  noise_keys: torch.Tensor, noise_scale: float):
    """Level-synchronous batched descent: all W lanes in lockstep — the
    plain version of the descent kernel (``kernels.ops.select_descent``).

    Each level gathers the lanes' child stats into one (W, C) tile
    (``tree.child_stat_tile``) and picks all W children with a single
    ``kernels.ops.uct_select`` call. Lanes that reached a not-fully-expanded
    or terminal node (or the depth cap) are masked out of the tile and held
    in place. Bit-identical to per-lane ``select_one`` under the same RNG
    schedule.

    On a forest (tree fields (E, cap + 1), ``root_board`` (E, n),
    ``noise_keys`` (E, W, 2)) all E·W lanes share each level's one
    (E·W, C) tile, and every output gains the member axis first, with
    member-local node ids — what ``jax.vmap(select_batch)`` returns.

    The loop ends when every lane is done: one host read per level.

    Returns (paths, depths, leaves, boards, n_empty), each batched over W.
    """
    max_depth = game.max_moves + 1
    cap = tree.cap
    C = tree.max_children
    shape = (*tree.parent.shape[:-1], noise_keys.shape[-2])   # (E,) W
    dev = root_board.device
    i32 = dict(dtype=torch.int32, device=dev)

    nodes = torch.zeros(shape, **i32)
    boards = root_board[..., None, :].expand(
        *shape, root_board.shape[-1]).clone()
    depths = torch.zeros(shape, **i32)
    paths = torch.full((*shape, max_depth), cap, **i32)
    paths[..., 0] = 0
    n_empty = (root_board == EMPTY).sum(-1).to(torch.int32)[..., None].expand(
        shape)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    tile = lambda t: t.reshape(-1, C)

    while not bool(done.all()):
        n_kids = gather_nodes(tree, tree.n_children, nodes)
        terminal = n_empty == 0
        fully = (n_kids == n_empty) & ~terminal
        safe, valid, wins, visits, vloss, ptot = child_stat_tile(tree, nodes)
        noise = (tile(level_noise(noise_keys, depths, C, noise_scale))
                 if noise_scale > 0.0 else None)
        picks = ops.uct_select(tile(wins), tile(visits), tile(vloss),
                               ptot.reshape(-1), tile(valid), cp,
                               noise=noise, lane_mask=~done.reshape(-1))
        child = safe.gather(-1, picks.view(shape).long()[..., None])[..., 0]
        # a held lane may sit on a childless node: its pick is slot 0, the
        # PAD row, whose move is the -1 sentinel. The result of placing it
        # is discarded by `step`; clamp so the scatter stays in bounds.
        mv = torch.clamp(gather_nodes(tree, tree.move, child), min=0)
        new_boards = game.place(boards, mv,
                                gather_nodes(tree, tree.to_move, nodes))
        step = fully & (depths < max_depth - 2) & ~done
        nodes = torch.where(step, child, nodes)
        boards = torch.where(step[..., None], new_boards, boards)
        paths = advance_paths(paths, depths, child, step)
        depths = torch.where(step, depths + 1, depths)
        n_empty = torch.where(step, n_empty - 1, n_empty)
        done = done | ~step
    return paths, depths, nodes, boards, n_empty


def select_batch(tree: Tree, root_board: torch.Tensor, game, cp,
                 noise_keys: torch.Tensor, noise_scale: float):
    """One selection round of W lanes: ``kernels.ops.select_descent`` — on
    the card ONE launch of the descent kernel, with no host read (for a
    forest too: one launch for all E·W lanes); on the CPU the lockstep
    level loop ``select_levels``. Both give the same (paths, depths,
    leaves, boards, n_empty), bit-identical to per-lane ``select_one``
    under the same RNG schedule."""
    return ops.select_descent(tree, root_board, game, cp,
                              noise_keys.contiguous(), noise_scale)


def propose_move(tree: Tree, leaf: torch.Tensor, board: torch.Tensor,
                 game, key: torch.Tensor) -> torch.Tensor:
    """Sample a uniformly-random untried move at `leaf` (-1 if none).

    "Random unexplored child" of the paper's expansion step. -1 (no
    expansion) also covers TERMINAL leaves: ``game.legal_mask`` is all-False
    there, so won/drawn positions are evaluated in place, never grown.

    Batched over leading axes: ``leaf`` (...), ``board`` (..., n_cells),
    ``key`` (..., 2); on a forest the leading axes start with the member
    axis and ``leaf`` is member-local. No host read.
    """
    n_cells = game.n_cells
    C = tree.max_children
    cap = tree.cap
    dev = board.device
    legal = game.legal_mask(board)
    rows = member_rows(tree, leaf)
    slots = rows_view(tree, tree.children)[rows]                  # (..., C)
    valid = (torch.arange(C, dtype=torch.int32, device=dev)
             < rows_view(tree, tree.n_children)[rows][..., None])
    tried_moves = torch.where(
        valid, gather_nodes(tree, tree.move, torch.where(valid, slots, cap)),
        n_cells)
    tried = torch.zeros((*legal.shape[:-1], n_cells + 1), dtype=torch.bool,
                        device=dev)
    tried.scatter_(-1, tried_moves.long(), True)
    untried = legal & ~tried[..., :n_cells]
    # argmax of iid uniforms over the untried set IS a uniform choice
    u = rng.uniform(key, n_cells)
    mv = torch.argmax(torch.where(untried, u, -1.0), dim=-1).to(torch.int32)
    return torch.where(untried.any(dim=-1), mv, NO_NODE)


# -------------------------------------------------------- dedup expansion ----
def expand_batch(tree: Tree, leaves: torch.Tensor, moves: torch.Tensor,
                 active: torch.Tensor):
    """Batch-insert unique (leaf, move) proposals; return per-worker node ids.

    The scatter/prefix-sum replacement for the paper's expansion-phase lock +
    atomic child index: proposals are sorted by (leaf, move) key, duplicates
    collapse onto their first occurrence, slots are rank-allocated.

    On a forest (``leaves``, ``moves``, ``active`` of shape (E, W),
    member-local leaves) all E·W proposals go through ONE sort whose leading
    key is the member (a member's leaf ``l`` sorts as row ``e·(cap + 1) +
    l``); ranks are counted per member, each member allocates from its own
    ``n_nodes``, and no two members share a slot or a counter — within a
    member the order, and so the lane that wins a collision, is the single
    tree's.

    Writes into ``tree`` in place and returns it with the (W,) / (E, W)
    member-local new ids (``cap`` where nothing was allocated). Every
    masked write lands on a PAD row; duplicate writes there may land in any
    order, which is harmless because they all carry the pad row's own
    values and the hygiene writes below restore it anyway.
    """
    cap = tree.cap
    E = tree.parent.shape[0] if tree.parent.dim() == 2 else 1
    dev = leaves.device
    INVALID = 2**30
    if E * (cap + 1) > INVALID:
        raise ValueError(f"expand_batch: {E} members of {cap + 1} rows exceed "
                         f"the sort key's {INVALID} rows")

    shape = leaves.shape
    leaves = leaves.to(torch.int32).reshape(-1)
    moves = moves.to(torch.int32).reshape(-1)
    N = leaves.numel()
    member = torch.arange(N, dtype=torch.int32, device=dev) // (N // E)
    base_row = member * (cap + 1)
    valid = (moves >= 0) & active.reshape(-1)
    leaf_k = torch.where(valid, leaves + base_row, INVALID)
    move_k = torch.where(valid, moves, INVALID)
    # lexicographic (member, leaf, move) order from ONE stable sort on a
    # packed 64-bit key: both halves are <= 2**30, so row * 2**31 + move is
    # exact
    packed = leaf_k.to(torch.int64) * (1 << 31) + move_k.to(torch.int64)
    _, order = torch.sort(packed, stable=True)
    leaf_s, move_s = leaf_k[order], move_k[order]
    member_s, base_s = member[order], base_row[order]
    valid_s = leaf_s < INVALID
    head = torch.ones((1,), dtype=torch.bool, device=dev)
    first = torch.cat(
        [head, (leaf_s[1:] != leaf_s[:-1]) | (move_s[1:] != move_s[:-1])]
    ) & valid_s
    # dup shares first's rank; g_rank counts over all members, uniq_rank
    # within the lane's member (less the uniques of the members before it)
    g_rank = torch.cumsum(first, dim=0, dtype=torch.int32) - 1
    if E > 1:
        n_uniq = torch.zeros((E,), dtype=torch.int32, device=dev).index_add_(
            0, member_s, first.to(torch.int32))
        before = torch.cumsum(n_uniq, dim=0, dtype=torch.int32) - n_uniq
        uniq_rank = g_rank - before[member_s]
    else:
        uniq_rank = g_rank
    n_nodes = tree.n_nodes.view(-1)                # (E,), a view
    nn_s = n_nodes[member_s]
    can = (nn_s + uniq_rank < cap) & valid_s
    alloc = first & can
    new_id_s = torch.where(can, nn_s + uniq_rank, cap)        # member-local

    pad_s = base_s + cap                           # the lane's member's PAD
    leaf_s = torch.where(valid_s, leaf_s, pad_s)   # a row of the flat view
    move_s = torch.where(valid_s, move_s, NO_NODE)

    # child-slot = existing n_children[leaf] + rank of this unique within its
    # leaf group (uniques of one leaf are contiguous in sorted order)
    leaf_prev = torch.cat(
        [torch.full((1,), -1, dtype=torch.int32, device=dev), leaf_s[:-1]])
    group_start = leaf_s != leaf_prev
    start_rank = torch.cummax(
        torch.where(group_start, g_rank, -1), dim=0).values
    within = g_rank - start_rank
    parent_f, move_f = rows_view(tree, tree.parent), rows_view(tree, tree.move)
    to_move_f = rows_view(tree, tree.to_move)
    children_f = rows_view(tree, tree.children)
    n_children_f = rows_view(tree, tree.n_children)
    slot = torch.clamp(n_children_f[leaf_s] + within, 0,
                       tree.max_children - 1)

    tgt = torch.where(alloc, new_id_s + base_s, pad_s)
    src_leaf = torch.where(alloc, leaf_s, pad_s)
    slot0 = torch.where(alloc, slot, 0)
    child_to_move = torch.where(alloc, 3 - to_move_f[leaf_s], 0)
    child_val = torch.where(alloc, new_id_s, children_f[src_leaf, slot0])

    parent_f[tgt] = torch.where(alloc, leaf_s - base_s, NO_NODE)
    move_f[tgt] = torch.where(alloc, move_s, NO_NODE)
    to_move_f[tgt] = child_to_move
    children_f[src_leaf, slot0] = child_val
    n_children_f.index_add_(0, src_leaf, alloc.to(torch.int32))

    # hygiene: pad rows never own state
    tree.parent[..., cap] = NO_NODE
    tree.move[..., cap] = NO_NODE
    tree.n_children[..., cap] = 0
    n_nodes.index_add_(0, member_s, alloc.to(torch.int32))

    # map back to worker order: duplicates get their first occurrence's id
    per_sorted = torch.where(valid_s & can, new_id_s, cap)
    new_ids = torch.zeros((N,), dtype=torch.int32, device=dev)
    new_ids[order] = per_sorted
    return tree, new_ids.view(shape)


# ---------------------------------------------------------- sync iteration ----
def sync_iteration(tree: Tree, root_board: torch.Tensor, cfg: GSCPMConfig,
                   cp, iter_keys: torch.Tensor, active: torch.Tensor,
                   metrics=None):
    """One batched GSCPM iteration of width W = cfg.n_workers.

    ``cp`` is passed beside ``cfg`` (never read from it here). Selection
    runs the level-synchronous batched descent by default;
    ``cfg.descent == "scalar"`` keeps the per-lane oracle (same RNG
    schedule, bit-identical trees). Likewise the playout phase defaults to
    the fused (W, cells) ``game.playout_batch`` and
    ``cfg.playout == "scalar"`` keeps the per-lane ``game.playout_scalar``
    oracle. Updates ``tree`` in place and returns it.

    On a forest (tree fields (E, cap + 1), ``root_board`` (E, n),
    ``iter_keys`` (E, W, 2), ``active`` (E, W)) the iteration runs ONE pass
    for all E members — one descent per selection round and one (E·W,
    cells) playout — and member e evolves exactly as the single tree
    would with its own board, keys and lanes (the port's ``jax.vmap``).
    """
    _check_in_slice(cfg, metrics=metrics)
    game = cfg.game_obj
    W = cfg.n_workers
    lead = tree.parent.shape[:-1]        # () or (E,)
    R = max(1, min(cfg.vl_rounds, W))
    while W % R != 0:  # R is a python int
        R -= 1
    Wr = W // R

    def scalar_lanes(t, board, k_noise, k_move):
        lanes = []
        for w in range(Wr):
            path, depth, leaf, b, _ = select_one(
                t, board, game, cp, k_noise[w], cfg.select_noise)
            mv = propose_move(t, leaf, b, game, k_move[w])
            lanes.append((path, depth, leaf, b, mv))
        return tuple(torch.stack(x) for x in zip(*lanes))

    def select_group(keys_g):
        # identical RNG schedule on both paths: per-lane (noise, move,
        # playout) keys come from one split of the lane's iteration key
        ks = rng.split(keys_g, 3)
        k_noise, k_move, k_po = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
        if cfg.descent == "scalar" and lead:
            per = [scalar_lanes(forest_member(tree, e), root_board[e],
                                k_noise[e], k_move[e]) for e in range(lead[0])]
            out = tuple(torch.stack(x) for x in zip(*per))
        elif cfg.descent == "scalar":
            out = scalar_lanes(tree, root_board, k_noise, k_move)
        else:
            paths, depths, leaves, boards, _ = select_batch(
                tree, root_board, game, cp, k_noise, cfg.select_noise)
            mvs = propose_move(tree, leaves, boards, game, k_move)
            out = (paths, depths, leaves, boards, mvs)
        return (*out, k_po)

    keys_r = iter_keys.reshape(*lead, R, Wr, 2)
    active_r = active.reshape(*lead, R, Wr)

    # virtual loss only influences the NEXT selection round of this
    # iteration; with a single round (R == 1) the add+reset pair is dead
    # weight — skipping it is bit-identical (no RNG is consumed)
    outs = []
    for r in range(R):
        out = select_group(keys_r[..., r, :, :])
        if R > 1:
            add_vloss(tree, out[0], active_r[..., r, :].to(torch.float32),
                      cfg.virtual_loss)
        outs.append(out)
    if R > 1:
        reset_vloss(tree)

    lane_axis = len(lead)
    paths, depths, leaves, boards, moves, po_keys = (
        torch.cat(x, dim=lane_axis) for x in zip(*outs))

    tree, new_ids = expand_batch(tree, leaves, moves, active)

    expanded = new_ids < tree.cap
    # the new node joins the backup path
    paths = advance_paths(paths, depths,
                          torch.where(expanded, new_ids, tree.cap),
                          torch.ones_like(expanded))

    # place each lane's proposed move (if any) — game-agnostic given the
    # shared board convention; lanes that proposed nothing evaluate the
    # leaf position itself (terminal leaves included)
    movers = gather_nodes(tree, tree.to_move, leaves)
    do = moves >= 0
    placed = game.place(boards, torch.clamp(moves, min=0), movers)
    b2 = torch.where(do[..., None], placed, boards)
    nxt = torch.where(do, 3 - movers, movers)
    n = b2.shape[-1]
    if cfg.playout == "scalar":
        # per-lane oracle: one scalar playout after the other
        winners = torch.stack([
            game.playout_scalar(b, t, k) for b, t, k in zip(
                b2.reshape(-1, n), nxt.reshape(-1), po_keys.reshape(-1, 2))])
    else:
        # fused leaf evaluation: ONE batched (E·W, cells) playout stage for
        # every lane of every member (bit-identical values to the oracle)
        winners = game.playout_batch(b2.reshape(-1, n), nxt.reshape(-1),
                                     po_keys.reshape(-1, 2))
    return backup_paths(tree, paths, winners.view(nxt.shape),
                        active.to(torch.float32))


def run_chunk(tree: Tree, root_board: torch.Tensor, cfg: GSCPMConfig,
              task_keys: torch.Tensor, active: torch.Tensor,
              m, cp, metrics=None):
    """Run `m` sync iterations (one task-grain per lane).

    ``m`` and ``cp`` are run-time values: a Python loop of ``m`` eager
    iterations, nothing compiled, so grain/Cp sweeps change no code path.
    The tree is updated IN PLACE (the port's counterpart of the JAX
    package's buffer donation) and returned. A forest with (E, W, 2)
    ``task_keys`` and (E, W) ``active`` runs all members in each iteration.
    """
    _check_in_slice(cfg, metrics=metrics)
    for i in range(int(m)):
        iter_keys = rng.fold_in(task_keys, i)
        tree = sync_iteration(tree, root_board, cfg, cp, iter_keys, active)
    return tree


# ------------------------------------------------------------------ search ----
def fold_task_keys(key: torch.Tensor, task_ids: torch.Tensor) -> torch.Tensor:
    """Per-task RNG streams: (2,) key, (W,) task ids -> (W, 2) keys."""
    return rng.fold_in(key, task_ids)


def run_schedule_round(tree: Tree, board: torch.Tensor, cfg: GSCPMConfig,
                       key: torch.Tensor, rnd: sched.Round, cp, metrics=None):
    """Advance one schedule ``Round``: the atomic dispatch unit of a search.

    Both the uninterrupted search loop (``gscpm_search``) and a serving engine
    run searches as a sequence of these calls — a round's RNG streams
    depend only on (``key``, ``rnd.task_ids``), never on wall-clock
    interleaving, so a search served in grain-sized quanta with preemptions
    in between is BIT-IDENTICAL to the same round sequence run back to
    back. The tree is updated in place and returned.
    """
    dev = board.device
    task_ids = torch.as_tensor(rnd.task_ids, dtype=torch.int32, device=dev)
    task_keys = fold_task_keys(key, task_ids)
    active = torch.as_tensor(rnd.active, device=dev)
    return run_chunk(tree, board, cfg, task_keys, active, int(rnd.m), cp,
                     metrics)


def warm_tree_check(tree: Tree, to_move: int, cfg: GSCPMConfig) -> None:
    """Eagerly validate a warm-start tree against the config.

    A warm tree with the wrong capacity or children width belongs to
    another search class, so shape mismatches fail loudly here. The
    side-to-move must also match: a re-rooted tree already knows whose turn
    it is, and searching it for the other player would corrupt the retained
    statistics' meaning.
    """
    if tree.cap != cfg.tree_cap:
        raise ValueError(
            f"warm tree cap {tree.cap} != cfg.tree_cap {cfg.tree_cap}; "
            "re-root with new_cap=cfg.tree_cap to match the serving class")
    n_actions = cfg.game_obj.n_actions
    if tree.max_children != n_actions:
        raise ValueError(
            f"warm tree max_children {tree.max_children} != game n_actions "
            f"{n_actions} — tree built for a different game class")
    tm = int(tree.to_move[..., 0].reshape(-1)[0])
    if tm != to_move:
        raise ValueError(
            f"warm tree root to_move {tm} != requested to_move {to_move}")


def gscpm_search(board: torch.Tensor, to_move: int, cfg: GSCPMConfig,
                 key: torch.Tensor, *, tree: Tree | None = None,
                 tracer=None, device=None,
                 plain_kernels: bool = False) -> tuple[Tree, dict[str, Any]]:
    """Full GSCPM search (paper Fig 4): schedule tasks, return tree + stats.

    ``device=None`` means ``torch.device("cuda")``; ``board``, ``key`` and a
    warm ``tree`` are moved there if they lie elsewhere.

    ``tree`` warm-starts the search from an existing tree. The schedule is
    exactly ``cfg``'s either way, so a warm search from tree T is
    bit-identical to a cold search whose ``init_tree`` was hand-replaced by
    T. The passed tree's tensors are UPDATED IN PLACE (when they already
    lie on ``device``), so the input object must not be reused as the old
    state afterwards.

    ``plain_kernels=True`` runs the whole search with the kernels' plain
    PyTorch versions even on the card (``kernels.ops.plain_versions``): a
    comparison mode, never the default.
    """
    _check_in_slice(cfg, tracer)
    device = torch.device("cuda") if device is None else torch.device(device)
    board = torch.as_tensor(board).to(device=device, dtype=torch.int8)
    key = key.to(device)
    reused_nodes = 0
    reused_visits = 0.0
    if tree is None:
        tree = init_tree(cfg.tree_cap, cfg.game_obj.n_actions, to_move,
                         device=device)
    else:
        tree = Tree(*(t.to(device) for t in tree))
        warm_tree_check(tree, to_move, cfg)
        reused_nodes = int(tree.n_nodes) - 1   # cold trees also own the root
        reused_visits = float(tree.visits[0])
    schedule = sched.make_schedule(
        cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler)

    cp = float(cfg.cp)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    playouts = 0
    masked_lane_iters = 0
    with ops.plain_versions() if plain_kernels else contextlib.nullcontext():
        for rnd in schedule:
            tree = run_schedule_round(tree, board, cfg, key, rnd, cp)
            playouts += int(rnd.active.sum()) * rnd.m
            masked_lane_iters += int((~rnd.active).sum()) * rnd.m
    sync()
    dt = time.perf_counter() - t0

    stats = {
        "time_s": dt,
        "playouts": playouts,
        "playouts_per_s": playouts / max(dt, 1e-9),
        "rounds": len(schedule),
        "grain": cfg.grain,
        "masked_lane_fraction": masked_lane_iters
        / max(1, playouts + masked_lane_iters),
        "tree_nodes": int(tree.n_nodes),
        "root_value": float(root_value(tree)),
        "best_move": int(best_child(tree)),
    }
    if reused_nodes or reused_visits:
        stats["reused_nodes"] = reused_nodes
        stats["reused_visits"] = reused_visits
    return tree, stats
