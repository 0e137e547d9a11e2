"""Device-side search metrics: per-iteration counters kept on the device.

Port of ``repro.obsv.search_metrics``, same names and counters. The paper's
companion study (arXiv:1409.4297) is pure measurement — where does a
thread's time go, how deep do descents run, how contended is the shared
tree. ``SearchMetrics`` is a NamedTuple of int32 tensors on the search's
device, threaded through ``gscpm.sync_iteration`` / ``run_chunk`` and the
forest chunk like the tree itself. Every update is a tensor op on the
device: nothing is read back to the host until ``summarize_metrics``,
which reads the whole accumulator once.

Two contracts, both held by tests/test_torch_obsv.py:

- **bit-identity**: metric updates are pure extra reductions over values
  the search already computes; they consume no RNG and feed nothing back,
  so a search with metrics on is bit-identical to the same search with
  metrics off.
- **nothing when off**: with ``cfg.metrics`` off the search runs no extra
  launch and no extra host read (the JAX package's "two programs" rule,
  which has no jit cache to count here).

All counters are int32, as in the JAX package: at these budgets (<= a few
million playouts, boards <= a few hundred cells) every counter stays far
below 2^31. A forest carries (E,) counters, one per member.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.game import EMPTY

_I32 = torch.int32


class SearchMetrics(NamedTuple):
    """Per-search counter accumulator.

    0-d tensors for a single tree; a forest carries the same fields with a
    leading (E,) member axis (``init_search_metrics_forest``).
    """

    sync_iterations: torch.Tensor        # batched GSCPM iterations run
    lane_playouts: torch.Tensor          # active lane-iterations == playouts
    masked_lane_iterations: torch.Tensor  # idle-lane slots (schedule masking)
    depth_sum: torch.Tensor              # Σ descent depth over active lanes
    depth_max: torch.Tensor              # deepest descent seen
    held_levels: torch.Tensor            # lane-levels idled while peers descended
    expand_proposals: torch.Tensor       # (leaf, move) expansion proposals
    expansions: torch.Tensor             # nodes actually allocated
    expand_collisions: torch.Tensor      # duplicate proposals collapsed
    leaf_collisions: torch.Tensor        # lanes sharing a leaf (vloss collisions)
    playout_moves: torch.Tensor          # Σ cells filled by playout evaluation
    playout_len_max: torch.Tensor        # longest single playout
    tree_nodes_peak: torch.Tensor        # max node occupancy observed
    # nodes inherited from a re-rooted tree at search start — seeded once by
    # the warm-start entry points, carried through iterations unchanged,
    # summed across members by ``summarize_metrics``
    tree_nodes_reused: torch.Tensor


_MAXED = frozenset({"depth_max", "playout_len_max", "tree_nodes_peak"})


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


def init_search_metrics(tree_nodes_reused: int = 0,
                        device=None) -> SearchMetrics:
    """Fresh all-zero accumulator (0-d fields) on ``device`` (None: cuda).

    ``tree_nodes_reused`` seeds the retention gauge for warm-started
    searches (``gscpm_search(tree=...)``): the node count inherited from a
    re-rooted tree, minus the trivial root (a cold tree also starts with 1
    node, so a cold search reports 0).
    """
    dev = _device(device)
    m = SearchMetrics(*(torch.zeros((), dtype=_I32, device=dev)
                        for _ in SearchMetrics._fields))
    if tree_nodes_reused:
        m = m._replace(tree_nodes_reused=torch.tensor(
            tree_nodes_reused, dtype=_I32, device=dev))
    return m


def init_search_metrics_forest(n_trees: int, device=None) -> SearchMetrics:
    """Per-member accumulator for an E-tree forest: every field is (E,)."""
    dev = _device(device)
    return SearchMetrics(*(torch.zeros((n_trees,), dtype=_I32, device=dev)
                           for _ in SearchMetrics._fields))


def _lanes(x: torch.Tensor):
    """(..., W) -> ((E·W,) flat, (E·W,) int64 member ids, E, (E·W,) lane
    ids): the leading axes are members (none for a single tree)."""
    W = max(1, x.shape[-1])
    flat = x.reshape(-1)
    lane = torch.arange(flat.numel(), device=x.device)
    return flat, lane // W, flat.numel() // W, lane


def _adjacent_dups(major: torch.Tensor, minor: torch.Tensor,
                   member: torch.Tensor, n_members: int) -> torch.Tensor:
    """(E,) int32: per member, how many entries equal the entry before them
    in lexicographic (major, minor) order (two stable sorts: minor, then
    major). An entry with a negative ``major`` never counts; ``major``
    carries the member as its leading part, so members never match."""
    o1 = torch.sort(minor, stable=True).indices
    order = o1[torch.sort(major[o1], stable=True).indices]
    a, b = major[order], minor[order]
    dup = torch.zeros_like(a, dtype=_I32)
    dup[1:] = ((a[1:] == a[:-1]) & (b[1:] == b[:-1]) & (a[1:] >= 0)).to(_I32)
    return torch.zeros((n_members,), dtype=_I32, device=a.device
                       ).index_add_(0, member[order], dup)


def _sorted_dup_count(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """How many masked-in entries duplicate an earlier equal entry.

    Masked-out lanes get a per-lane-unique sentinel so they can never count
    as duplicates of each other; a masked-in negative key never counts
    (the JAX package's ``a_s >= 0`` test). Over (W,) it returns a 0-d
    count; over (E, W) one count per member, with sentinels unique across
    members and a member's keys never matching another member's.
    """
    flat, member, E, lane = _lanes(keys)
    ok = mask.reshape(-1) & (flat >= 0)
    major = torch.where(ok, (member << 32) + flat.to(torch.int64), -1 - lane)
    return _adjacent_dups(major, torch.zeros_like(major), member,
                          E).reshape(keys.shape[:-1])


def _pair_dup_count(leaves: torch.Tensor, moves: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Duplicate (leaf, move) pairs among masked-in proposals, counted over
    the lexicographic (member, leaf, move) order that ``gscpm.expand_batch``
    allocates with — two sort keys, so no packing limit on the leaf or
    move range. Masked-out lanes get unique negative sentinels, unique
    across members too, and a masked-in negative leaf never counts.
    Shapes as in ``_sorted_dup_count``."""
    lf, member, E, lane = _lanes(leaves)
    ok = mask.reshape(-1) & (lf >= 0)
    major = torch.where(ok, (member << 32) + lf.to(torch.int64), -1 - lane)
    minor = torch.where(ok, moves.reshape(-1).to(torch.int64), 0)
    return _adjacent_dups(major, minor, member, E).reshape(leaves.shape[:-1])


def accumulate_iteration(m: SearchMetrics, *, depths_grouped: torch.Tensor,
                         active: torch.Tensor, leaves: torch.Tensor,
                         moves: torch.Tensor, eval_boards: torch.Tensor,
                         n_nodes_before: torch.Tensor,
                         n_nodes_after: torch.Tensor) -> SearchMetrics:
    """Fold one ``sync_iteration``'s observations into the accumulator.

    Every input is a value the iteration computed anyway (with a leading
    (E,) member axis on a forest, matching ``m``'s fields):

    - ``depths_grouped``: (R, Wr) descent depths, grouped by virtual-loss
      round — on the card the ``depths`` output of each round's
      ``select_descent`` launch, stacked. Held levels are counted against
      each group's own deepest lane, because that is the lockstep descent
      the group ran;
    - ``leaves``/``moves``: (W,) selected leaves and proposed expansion
      moves (−1 = no proposal);
    - ``eval_boards``: (W, n_cells) positions handed to the playout stage
      (its empty count IS the playout length — the fill stage plays until
      the board is full);
    - ``n_nodes_before/after``: allocation counter around ``expand_batch``.

    Returns a new accumulator; nothing is read back to the host.
    """
    lead = tuple(m.sync_iterations.shape)              # () or (E,)
    E = lead[0] if lead else 1
    R, Wr = depths_grouped.shape[-2:]
    W = R * Wr
    dg = depths_grouped.reshape(E, R, Wr).to(_I32)
    depths = dg.reshape(E, W)
    act = active.reshape(E, W)
    act_i = act.to(_I32)
    mv = moves.reshape(E, W)

    def per(x):                                        # (E, ...) -> lead
        return x.reshape(lead).to(_I32)

    w_active = per(act_i.sum(1))
    held = per((dg.amax(dim=2, keepdim=True) - dg).sum((1, 2)))
    proposals = per(((mv >= 0) & act).sum(1))
    playout_len = (eval_boards.reshape(E, W, -1) == EMPTY).sum(2).to(_I32)
    d_act = depths * act_i
    p_act = playout_len * act_i
    return SearchMetrics(
        sync_iterations=m.sync_iterations + 1,
        lane_playouts=m.lane_playouts + w_active,
        masked_lane_iterations=m.masked_lane_iterations + (W - w_active),
        depth_sum=m.depth_sum + per(d_act.sum(1)),
        depth_max=torch.maximum(m.depth_max, per(d_act.amax(1))),
        held_levels=m.held_levels + held,
        expand_proposals=m.expand_proposals + proposals,
        expansions=m.expansions + (n_nodes_after - n_nodes_before).to(_I32),
        expand_collisions=m.expand_collisions + _pair_dup_count(
            leaves, moves, (moves >= 0) & active),
        leaf_collisions=m.leaf_collisions + _sorted_dup_count(leaves, active),
        playout_moves=m.playout_moves + per(p_act.sum(1)),
        playout_len_max=torch.maximum(m.playout_len_max,
                                      per(p_act.amax(1))),
        tree_nodes_peak=torch.maximum(m.tree_nodes_peak,
                                      n_nodes_after.to(_I32)),
        tree_nodes_reused=m.tree_nodes_reused,  # seeded at init, not per-iter
    )


def merge_metrics(a: SearchMetrics, b: SearchMetrics) -> SearchMetrics:
    """Combine two accumulators (sums for counters, max for the gauges)."""
    return SearchMetrics(*[
        torch.maximum(x, y) if f in _MAXED else x + y
        for f, x, y in zip(SearchMetrics._fields, a, b)])


def summarize_metrics(m: SearchMetrics) -> dict:
    """One host read -> a plain dict of counters + derived rates.

    Accepts a single-tree accumulator or a forest one (leading member axis
    — members are merged first, on the device, so the summary is
    whole-ensemble).
    """
    fields = [torch.as_tensor(x).reshape(-1) for x in m]
    merged = [x.amax() if f in _MAXED else x.sum()
              for f, x in zip(SearchMetrics._fields, fields)]
    values = torch.stack([x.to(torch.int64) for x in merged]).cpu().tolist()
    host = dict(zip(SearchMetrics._fields, (int(v) for v in values)))
    playouts = max(1, host["lane_playouts"])
    host["depth_mean"] = host["depth_sum"] / playouts
    host["playout_len_mean"] = host["playout_moves"] / playouts
    host["expand_collision_rate"] = (
        host["expand_collisions"] / max(1, host["expand_proposals"]))
    host["leaf_collision_rate"] = host["leaf_collisions"] / playouts
    return host
