"""Root-parallel batched GSCPM: many trees, one pass per sync iteration.

Port of ``repro.core.root_parallel``. The source paper scales ONE shared
tree across 244 threads (tree parallelism); its companion studies use the
orthogonal axis — *root parallelism*: E independent trees search the same
(or different) root positions and their root statistics are merged. The E
trees are stacked into one forest (a leading member axis on every ``Tree``
field, ``core.tree.init_forest``) and each sync iteration advances ALL of
them in one pass: one descent per selection round for every lane of every
member (on the card one ``select_descent`` launch), one (E·W, cells)
playout (for Hex one ``hex_playout`` launch), one expansion and one backup
— the port's counterpart of the JAX package's ``jax.vmap`` over the
single-tree chunk. No Python loop runs over members.

Three merge disciplines:

- **visit-sum** (``ensemble_best_move``): per-move root-child visits are
  summed across members; play the argmax.
- **majority vote** (``majority_vote_move``): each member votes its own
  most-visited move; play the mode.
- **periodic sync** (``sync_root_stats``): every ``merge_every`` rounds each
  member's root-child statistics are refreshed with the *sum of every other
  member's own contribution*. Contributions are tracked as deltas
  (``RootSyncState``), which makes the merge exact — repeated syncs never
  double-count, and after a final sync every member's root visit count
  equals the total playouts of the whole ensemble.

Member streams: member e's key is ``fold_in(key, e)`` and its lanes' task
keys ``fold_in(member_key, task_id)``, so member e of a forest with
``merge_every = 0`` is exactly ``gscpm_search(board, to_move, cfg,
fold_in(key, e))``.

**Sharding over cards.** With an ensemble mesh (``launch.mesh``: an
ordered list of devices on the axis ``"ens"``) the E members — padded to a
multiple of the mesh size with bitwise-inert members — split into
contiguous blocks, one block a shard, each on its own device with its own
storage (``core.tree.split_members``). One process drives every shard (a
single controller, as the JAX package's ``shard_map`` program is): each
schedule round runs ``run_chunk`` once a shard, so ``select_descent`` and
``hex_playout`` each launch once a shard a sync iteration, and
``sync_root_stats`` is the only cross-shard exchange. ``device=`` takes a
list of devices; ``device=None`` (or ``"cuda"``) on a host with several
cards shards over all of them, as the reference shards over its visible
devices. A device may repeat: two entries of one device are two virtual
shards, which is how the CPU tests and ``chip_smoke.py`` on one card
rehearse the multi-card path. The sharded search is bit-identical to the
one-device search. One thread dispatches every shard, so a round costs n
times the launches of one shard: sharding buys memory and correctness on
many cards, not speed, until queue B's host work lands.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import scheduler as sched
from repro_torch.core.gscpm import (
    GSCPMConfig,
    fold_task_keys,
    run_chunk,
    warm_tree_check,
)
from repro_torch.core.tree import (
    Tree,
    _root_children,
    best_child,
    check_invariants,
    concat_members,
    forest_member,
    forest_size,
    init_forest,
    root_move_stats,
    root_value,
    split_members,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (make_ensemble_mesh, mesh_dims,
                                     resolve_device, visible_devices)
from repro_torch.obsv.search_metrics import (
    init_search_metrics_forest,
    summarize_metrics,
)
from repro_torch.obsv.trace import stage
from repro_torch.sharding.rules import (DEFAULT_RULES, NamedSharding,
                                        logical_to_spec)


# ----------------------------------------------------------- forest chunk ----
def _forest_chunk(forest: Tree, boards: torch.Tensor, cfg: GSCPMConfig,
                  task_keys: torch.Tensor, active: torch.Tensor,
                  m, cp, metrics=None):
    """``gscpm.run_chunk`` on a forest: ``m`` sync iterations, each ONE pass
    for all E members (boards (E, n), task_keys (E, W, 2), active (E, W)).
    All members share the round's grain ``m`` and ``cp``; per-member RNG
    streams keep their searches decorrelated. Updates the forest in place
    and returns it. ``cfg.metrics`` threads a per-member ``SearchMetrics``
    accumulator ((E,) fields, ``init_search_metrics_forest``) through the
    same pass and returns ``(forest, metrics)``: the duplicate counts are
    per member (the member is the sort's leading key)."""
    return run_chunk(forest, boards, cfg, task_keys, active, m, cp, metrics)


run_chunk_forest = _forest_chunk


def _on(device: torch.device):
    """Make ``device`` the current CUDA device while a shard runs (the
    kernels launch on the current device); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def synchronize(devices) -> None:
    """Wait for the queued work of every CUDA device in ``devices``:
    ``torch.cuda.synchronize()`` alone waits on the current device only."""
    seen = set()
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d not in seen:
            seen.add(d)
            torch.cuda.synchronize(d)


def ensemble_mesh(devices=None):
    """The 1-D ``"ens"`` mesh over ``devices`` (default: every visible CUDA
    device); None with fewer than two entries, as in the JAX package.
    Built through ``launch.mesh.make_ensemble_mesh``, whose axis the
    ``sharding/rules.py`` "ensemble" rule maps onto. A CUDA entry the host
    lacks raises."""
    devices = visible_devices() if devices is None else list(devices)
    if len(devices) <= 1:
        return None
    return make_ensemble_mesh(devices)


def ensemble_devices(device=None, shard: str = "auto"):
    """(home device, ensemble mesh or None) for a forest asked to run on
    ``device``: a list or tuple of devices is the mesh's entries (repeats
    are virtual shards); None or ``"cuda"`` means every visible card when
    there are several, else the current card; any other device is one
    device. ``shard="off"`` keeps the first entry alone. The home device —
    the first entry — holds the gathered forest."""
    if isinstance(device, (list, tuple)):
        devs = [resolve_device(d) for d in device]
        if not devs:
            raise ValueError("device=[]: an ensemble needs a device")
    else:
        d = torch.device("cuda") if device is None else torch.device(device)
        many = (d.type == "cuda" and d.index is None
                and torch.cuda.device_count() > 1)
        devs = visible_devices() if many else [d]
    mesh = ensemble_mesh(devs) if shard != "off" else None
    return devs[0], mesh


def ensemble_spec(mesh):
    """``P("ens")`` for the forest's leading member axis, derived through
    the logical-axis rules rather than spelled by hand."""
    return logical_to_spec(("ensemble",), DEFAULT_RULES, mesh)


def ensemble_sharding(n_trees: int, mesh=None):
    """(NamedSharding over the ensemble axis, padded member count).

    Returns ``(None, n_trees)`` with fewer than two mesh entries. A member
    count that does not divide the mesh is PADDED up to the next multiple:
    pad members only ever run under all-False ``active`` masks, which
    leaves their trees bit-identical to init and their contribution to
    every merge exactly zero, so real members match the unpadded,
    unsharded run bit for bit.
    """
    mesh = ensemble_mesh() if mesh is None else mesh
    if mesh is None:
        return None, n_trees
    n_dev = mesh.size
    padded = ((n_trees + n_dev - 1) // n_dev) * n_dev
    return NamedSharding(mesh, ensemble_spec(mesh)), padded


def _shard_devices(mesh, shards) -> list[torch.device]:
    devs = mesh.device_list()
    if len(shards) != len(devs):
        raise ValueError(f"{len(shards)} shards for a mesh of {len(devs)}")
    for s, (f, d) in enumerate(zip(shards, devs)):
        if f.device != d:
            raise ValueError(f"shard {s} lies on {f.device}, its mesh entry "
                             f"is {d}")
    return devs


def _sharded_chunk(forest, boards, task_keys, active, m, cp, *, cfg, mesh):
    """The forest chunk over an ensemble mesh: ``forest``, ``boards``,
    ``task_keys`` and ``active`` are lists, one entry a shard on its mesh
    device, and each shard runs ``_forest_chunk`` (unchanged) on its own
    members with its device current — ZERO cross-shard exchange here;
    ``sync_root_stats`` stays the only one. Per-shard RNG is free:
    ``task_keys`` are folded from member keys that were folded over the
    GLOBAL member ids before the split, so a member's stream is identical
    no matter which shard hosts it. Returns the list of shard forests."""
    devs = _shard_devices(mesh, forest)
    out = []
    for s, dev in enumerate(devs):
        with _on(dev):
            out.append(_forest_chunk(forest[s], boards[s], cfg, task_keys[s],
                                     active[s], m, cp))
    return out


def _sharded_chunk_metrics(forest, boards, task_keys, active, m, cp, metrics,
                           *, cfg, mesh):
    """``_sharded_chunk`` with the (E,)-field ``SearchMetrics`` accumulator
    split the same way (a list, one a shard; pad members see only
    masked-out work). Returns (shard forests, shard accumulators)."""
    devs = _shard_devices(mesh, forest)
    trees, accs = [], []
    for s, dev in enumerate(devs):
        with _on(dev):
            f, mm = _forest_chunk(forest[s], boards[s], cfg, task_keys[s],
                                  active[s], m, cp, metrics[s])
        trees.append(f)
        accs.append(mm)
    return trees, accs


def pad_forest_members(forest: Tree, boards: torch.Tensor, n_padded: int,
                       cfg: GSCPMConfig, to_move) -> tuple[Tree, torch.Tensor]:
    """Append inert members until the ensemble axis has ``n_padded`` rows.

    Pad members get fresh init trees and a copy of member 0's board; they
    only ever run with all-False ``active`` masks, so they allocate nothing
    and back up nothing. Callers slice results back to the real count.
    """
    extra = n_padded - forest_size(forest)
    if extra <= 0:
        return forest, boards
    tm = int(torch.as_tensor(to_move).reshape(-1)[0])
    pad = init_forest(extra, cfg.tree_cap, cfg.game_obj.n_actions, tm,
                      device=forest.device)
    forest = Tree(*(torch.cat([a, b]) for a, b in zip(forest, pad)))
    boards = torch.cat([boards, boards[:1].expand(extra, -1)])
    return forest, boards


def fold_member_task_keys(member_keys: torch.Tensor,
                          task_ids: torch.Tensor) -> torch.Tensor:
    """(E, 2) member streams x (W,) task ids -> (E, W, 2) per-lane streams."""
    return rng.fold_in(member_keys[:, None, :], task_ids[None, :])


def _round_inputs(member_keys: torch.Tensor, rnd: sched.Round,
                  n_real: int | None, first: int):
    """(task keys (Es, W, 2), active (Es, W)) of one Round for the members
    ``first .. first + Es`` of the ensemble, on their keys' device; members
    at or past ``n_real`` (pads) run with all-False ``active``."""
    dev = member_keys.device
    Es = member_keys.shape[0]
    task_keys = fold_member_task_keys(
        member_keys, torch.as_tensor(rnd.task_ids, dtype=torch.int32,
                                     device=dev))
    act = np.tile(np.asarray(rnd.active)[None, :], (Es, 1))
    if n_real is not None and n_real < first + Es:
        act[max(0, n_real - first):] = False
    return task_keys, torch.as_tensor(act, device=dev)


def run_schedule_round_forest(forest: Tree, boards: torch.Tensor,
                              cfg: GSCPMConfig, member_keys: torch.Tensor,
                              rnd: sched.Round, cp, metrics=None, *,
                              n_real: int | None = None, mesh=None):
    """Forest twin of ``gscpm.run_schedule_round``: one schedule ``Round``
    for all E members — the quantum unit shared by the batch driver
    (``gscpm_search_batch``) and a serving engine. Round RNG depends only
    on (member key, task id, iteration), never on sharding, padding or
    wall-clock interleaving.

    ``n_real`` masks pad members (rows ``>= n_real`` of the whole ensemble
    run with all-False ``active`` — bitwise inert). With ``mesh``,
    ``forest``, ``boards``, ``member_keys`` and ``metrics`` are lists with
    one entry a mesh device (``core.tree.split_members``) and the round
    runs ``_sharded_chunk`` (``_sharded_chunk_metrics``).
    The forest is updated in place and returned; with ``cfg.metrics`` the
    accumulator rides along and the round returns ``(forest, metrics)``.
    """
    m = int(rnd.m)
    if mesh is None:
        with stage("round_inputs"):
            task_keys, active = _round_inputs(member_keys, rnd, n_real, 0)
        return run_chunk_forest(forest, boards, cfg, task_keys, active, m,
                                cp, metrics)
    inputs, first = [], 0
    with stage("round_inputs"):
        for mk in member_keys:
            inputs.append(_round_inputs(mk, rnd, n_real, first))
            first += mk.shape[0]
    task_keys, active = [i[0] for i in inputs], [i[1] for i in inputs]
    if cfg.metrics:
        return _sharded_chunk_metrics(forest, boards, task_keys, active, m,
                                      cp, metrics, cfg=cfg, mesh=mesh)
    return _sharded_chunk(forest, boards, task_keys, active, m, cp, cfg=cfg,
                          mesh=mesh)


# ----------------------------------------------------------------- merges ----
def merged_root_stats(forest: Tree, n_moves: int):
    """Summed per-move root (visits, wins) across members: (n_moves,) each."""
    v, w = root_move_stats(forest, n_moves)
    return v.sum(dim=0), w.sum(dim=0)


def ensemble_best_move(forest: Tree, n_moves: int) -> torch.Tensor:
    """Visit-sum merge: argmax of summed root-child visits."""
    visits, _ = merged_root_stats(forest, n_moves)
    return torch.argmax(visits).to(torch.int32)


def majority_vote_move(forest: Tree, n_moves: int) -> torch.Tensor:
    """Mode of the per-member most-visited moves (ties -> lowest move id)."""
    votes = best_child(forest)  # (E,)
    counts = torch.zeros((n_moves,), dtype=torch.int32, device=forest.device)
    counts.index_add_(0, torch.clamp(votes, 0, n_moves - 1),
                      torch.ones_like(votes))
    return torch.argmax(counts).to(torch.int32)


def forest_summary(forest: Tree, n_moves: int) -> dict[str, torch.Tensor]:
    """All end-of-search reductions, as tensors on the forest's device."""
    visits, _ = merged_root_stats(forest, n_moves)
    return {
        "member_best_moves": best_child(forest),
        "member_root_values": root_value(forest),
        "best_move_sum": torch.argmax(visits).to(torch.int32),
        "best_move_vote": majority_vote_move(forest, n_moves),
    }


def forest_retire_summary(forest: Tree, n_moves: int) -> dict:
    """Device-side merged root snapshot of a forest: the forest twin of
    ``tree.root_summary_device``, read later with
    ``materialize_forest_summary``. Merged ``best_move`` follows the
    single-tree contract: ``-1`` when no member has expanded a root child
    yet."""
    visits, wins = merged_root_stats(forest, n_moves)
    rv = forest.visits[:, 0].sum()
    rw = forest.wins[:, 0].sum()
    return {
        "root_visits": visits,
        "root_wins": wins,
        "best_move": torch.where(visits.sum() > 0, torch.argmax(visits),
                                 -1).to(torch.int32),
        "best_move_vote": majority_vote_move(forest, n_moves),
        "member_best_moves": best_child(forest),
        "root_value": torch.where(rv > 0, rw / torch.clamp(rv, min=1.0), 0.0),
        "tree_nodes": forest.n_nodes.sum(),
    }


def forest_root_summary(forest: Tree, n_moves: int,
                        n_real: int | None = None) -> dict:
    """Host-side merged root snapshot, shaped like ``tree.root_summary``
    plus ensemble extras (vote move, per-member best moves). ``n_real``
    slices off pad members first."""
    if n_real is not None and n_real < forest_size(forest):
        forest = Tree(*(x[:n_real] for x in forest))
    return materialize_forest_summary(forest_retire_summary(forest, n_moves),
                                      forest_size(forest))


def materialize_forest_summary(dev: dict, n_trees: int) -> dict:
    """Pull a ``forest_retire_summary`` dict to plain host types."""
    return {
        "root_visits": dev["root_visits"].cpu().numpy(),
        "root_wins": dev["root_wins"].cpu().numpy(),
        "best_move": int(dev["best_move"]),
        "root_value": float(dev["root_value"]),
        "tree_nodes": int(dev["tree_nodes"]),
        "n_trees": n_trees,
        "best_move_vote": int(dev["best_move_vote"]),
        "member_best_moves": dev["member_best_moves"].cpu().numpy().tolist(),
    }


# ---------------------------------------------------------- periodic sync ----
class RootSyncState(NamedTuple):
    """Foreign (other-member) statistics already injected into each tree.

    Tracking what was injected lets ``sync_root_stats`` recover each member's
    OWN contribution exactly (own = in-tree − injected), so the merge never
    double-counts across repeated syncs.
    """

    visits: torch.Tensor       # (E, n_moves) f32 injected per-move visits
    wins: torch.Tensor         # (E, n_moves) f32 injected per-move wins
    root_visits: torch.Tensor  # (E,) f32 injected root-node visits
    root_wins: torch.Tensor    # (E,) f32 injected root-node wins


def init_sync_state(n_trees: int, n_moves: int, device=None) -> RootSyncState:
    device = torch.device("cuda") if device is None else torch.device(device)
    z = torch.zeros((n_trees, n_moves), dtype=torch.float32, device=device)
    z1 = torch.zeros((n_trees,), dtype=torch.float32, device=device)
    return RootSyncState(visits=z, wins=z.clone(), root_visits=z1,
                         root_wins=z1.clone())


def _own_root_stats(forest: Tree, state: RootSyncState, n_moves: int):
    """Each member's OWN root statistics (in-tree minus injected): (E, M)
    per-move visits and wins, (E,) root visits and wins."""
    dense_v, dense_w = root_move_stats(forest, n_moves)
    return (dense_v - state.visits, dense_w - state.wins,
            forest.visits[:, 0] - state.root_visits,
            forest.wins[:, 0] - state.root_wins)


def _inject_root_stats(forest: Tree, state: RootSyncState, own, total,
                       n_moves: int) -> tuple[Tree, RootSyncState]:
    """Write into each member the ensemble ``total`` of own statistics less
    its own (Σ others' own), replacing what was injected before."""
    cap = forest.cap
    own_v, own_w, own_rv, own_rw = own
    tot_v, tot_w, tot_rv, tot_rw = total
    new_f_v = tot_v[None, :] - own_v              # Σ others' own
    new_f_w = tot_w[None, :] - own_w
    new_f_rv = tot_rv - own_rv
    new_f_rw = tot_rw - own_rw

    valid, safe = _root_children(forest)                          # (E, C)
    mv = torch.clamp(torch.where(valid, forest.move.gather(1, safe), 0),
                     0, n_moves - 1).long()
    forest.visits.scatter_add_(1, safe, torch.where(
        valid, new_f_v.gather(1, mv) - state.visits.gather(1, mv), 0.0))
    forest.wins.scatter_add_(1, safe, torch.where(
        valid, new_f_w.gather(1, mv) - state.wins.gather(1, mv), 0.0))
    forest.visits[:, cap] = 0.0
    forest.wins[:, cap] = 0.0
    forest.visits[:, 0] += new_f_rv - state.root_visits
    forest.wins[:, 0] += new_f_rw - state.root_wins
    # record only what was actually injected (moves with a child row)
    has = torch.zeros((*mv.shape[:-1], n_moves + 1), dtype=torch.bool,
                      device=forest.device).scatter_(
        1, torch.where(valid, mv, n_moves), True)[:, :n_moves]
    return forest, RootSyncState(
        visits=torch.where(has, new_f_v, 0.0),
        wins=torch.where(has, new_f_w, 0.0),
        root_visits=new_f_rv, root_wins=new_f_rw)


def sync_root_stats(forest, state, n_moves: int):
    """Refresh every member's root stats with the other members' own work.

    After the call, member e's root child for move a holds
    ``own_e(a) + Σ_{e'≠e} own_e'(a)`` — for the moves e has expanded;
    moves a member has not discovered receive nothing (it cannot host a
    child row for them), which is the standard root-parallel partial-merge
    semantics. Writes into the forest in place; returns it and the new
    state.

    On shards (``forest`` and ``state`` lists, one entry a mesh device):
    each shard sums its members' own statistics on its own device, the
    partial sums go to the first shard's device and are added there in
    shard order, and the total goes back to every shard, which injects it
    into its members — the only cross-shard exchange of a sharded search.
    Every statistic is a sum of half-integers, so the float32 sums are
    exact, and therefore independent of the order of the adds, only while
    every summed count stays below 2^24; the sharded and the one-device
    merges (and the JAX package's) rely on that alike.
    """
    if isinstance(forest, Tree):
        own = _own_root_stats(forest, state, n_moves)
        return _inject_root_stats(forest, state, own,
                                  tuple(x.sum(dim=0) for x in own), n_moves)
    owns = [_own_root_stats(f, st, n_moves) for f, st in zip(forest, state)]
    home = forest[0].device
    partial = [[x.sum(dim=0).to(home) for x in own] for own in owns]
    total = partial[0]
    for p in partial[1:]:
        total = [t + q for t, q in zip(total, p)]
    out = [_inject_root_stats(f, st, own, tuple(t.to(f.device)
                                                for t in total), n_moves)
           for f, st, own in zip(forest, state, owns)]
    return [f for f, _ in out], [st for _, st in out]


# ------------------------------------------------------------------ driver ----
def gscpm_search_batch(boards: torch.Tensor, to_move, cfg: GSCPMConfig,
                       key: torch.Tensor, *, n_trees: int | None = None,
                       merge_every: int = 0, forest: Tree | None = None,
                       shard: str = "auto", tracer=None, device=None,
                       plain_kernels: bool = False
                       ) -> tuple[Tree, dict[str, Any]]:
    """Root-parallel GSCPM over E trees, one pass per sync iteration.

    boards: (E, n_cells) — one root position per member (multi-request
    search), or (n_cells,) with ``n_trees=E`` — an E-member ensemble on one
    position. ``to_move`` is scalar or (E,). ``merge_every > 0`` enables
    periodic root synchronization (plus a final sync before move selection).

    ``forest`` warm-starts all E members from an existing forest — typically
    ``reroot_forest``'s output after a move. The member count must match the
    boards batch; the schedule stays exactly ``cfg``'s. On one device the
    forest's tensors are updated in place (when they already lie there);
    a sharded search splits a copy and returns a new forest.

    ``device``: None means ``torch.device("cuda")`` — every visible card
    when the host has several —; a list of devices is an ensemble mesh
    (repeat a device for virtual shards: ``["cpu"] * 4``). ``shard``:
    ``"auto"`` shards the members over the mesh whenever it has two or
    more entries (padding E up to a multiple of its size: pad members are
    bitwise inert), ``"off"`` runs on the first device alone,
    ``"require"`` raises ``RuntimeError`` unless a mesh of two or more
    entries is there. The sharded search is bit-identical to the unsharded
    one: member keys are folded over the global member ids before the
    split, and the only exchange is ``sync_root_stats``' exact merge. Its
    result is gathered onto the first device as one ``(E, cap + 1)``
    forest, so ``forest_summary``, ``reroot_forest`` and a warm search
    (which splits it again) work unchanged — which holds one whole forest
    on the first card (1.07 GB at 8 x (2^18 + 1) rows).

    ``cfg.metrics`` adds a whole-ensemble ``stats["metrics"]`` summary
    (members merged: counters summed, gauges maxed); ``tracer`` records
    per-round ``gscpm_round`` spans, synchronising every shard's device
    inside each (a profiling mode — see ``gscpm.gscpm_search``).
    ``plain_kernels=True`` runs the whole search with the kernels' plain
    versions even on the card (a comparison mode).
    """
    if shard not in ("auto", "off", "require"):
        raise ValueError(f"shard must be 'auto'|'off'|'require', "
                         f"got {shard!r}")
    device, mesh = ensemble_devices(device, shard)
    if shard == "require" and mesh is None:
        raise RuntimeError(
            "shard='require' but the ensemble mesh has fewer than two "
            "entries — pass device=[...] with two or more (repeat a device "
            "for virtual shards; README 'Scaling out')")
    with stage("init"):
        boards = torch.as_tensor(boards).to(device=device, dtype=torch.int8)
        if boards.dim() == 1:
            if n_trees is None and forest is not None:
                n_trees = forest_size(forest)   # warm restart implies E
            boards = boards[None, :].expand(n_trees or 1, -1)
        boards = boards.contiguous()
        E = boards.shape[0]
        if n_trees is not None and n_trees != E:
            raise ValueError(f"n_trees={n_trees} != boards.shape[0]={E}")
        n_moves = cfg.game_obj.n_actions  # the Game seam's move-id space
        key = key.to(device)

        reused_nodes = 0
        if forest is None:
            forest = init_forest(E, cfg.tree_cap, n_moves, to_move,
                                 device=device)
        else:
            if forest_size(forest) != E:
                raise ValueError(
                    f"warm forest has {forest_size(forest)} members, "
                    f"boards batch has {E}")
            forest = Tree(*(t.to(device) for t in forest))
            tm = int(torch.as_tensor(to_move).reshape(-1)[0])
            warm_tree_check(forest, tm, cfg)
            reused_nodes = int(forest.n_nodes.sum()) - E
        padded_members = 0
        Ep = E
        if mesh is not None:
            _, Ep = ensemble_sharding(E, mesh)
            padded_members = Ep - E
            forest, boards = pad_forest_members(forest, boards, Ep, cfg,
                                                to_move)
        # folded over the GLOBAL member ids before any split: a member's
        # stream never depends on the shard that hosts it
        member_keys = fold_task_keys(
            key, torch.arange(Ep, dtype=torch.int32, device=device))
        schedule = sched.make_schedule(
            cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler)
        state = (init_sync_state(Ep, n_moves, device) if merge_every > 0
                 else None)
        metrics = None
        if cfg.metrics:
            metrics = init_search_metrics_forest(Ep, device)
            if reused_nodes:
                # per-member retention gauge (summed in the ensemble summary;
                # pad members report 0 — their forests are fresh inits)
                metrics = metrics._replace(
                    tree_nodes_reused=(forest.n_nodes - 1).to(torch.int32))
        devices = [device]
        if mesh is not None:
            devices = mesh.device_list()
            forest = split_members(forest, devices)
            boards = split_members(boards, devices)
            member_keys = split_members(member_keys, devices)
            if state is not None:
                state = split_members(state, devices)
            if metrics is not None:
                metrics = split_members(metrics, devices)

        synchronize(devices)
    cp = float(cfg.cp)
    t0 = time.perf_counter()
    playouts_per_tree = 0
    n_syncs = 0
    with ops.plain_versions() if plain_kernels else contextlib.nullcontext():
        for r, rnd in enumerate(schedule):
            span_args = {"rounds": 1, "iterations": int(rnd.m),
                         "lane_iterations": E * int(rnd.active.sum()) * rnd.m,
                         "tasks": E * int(rnd.active.sum()),
                         "workers": E * cfg.n_workers, "game": cfg.game}
            with (tracer.span("gscpm_round", span_args) if tracer
                  else contextlib.nullcontext()):
                out = run_schedule_round_forest(forest, boards, cfg,
                                                member_keys, rnd, cp, metrics,
                                                n_real=E, mesh=mesh)
                forest, metrics = out if cfg.metrics else (out, metrics)
                if tracer:
                    synchronize(devices)
            if tracer:
                tracer.poll_compiles()
            playouts_per_tree += int(rnd.active.sum()) * rnd.m
            if merge_every > 0 and ((r + 1) % merge_every == 0
                                    or r == len(schedule) - 1):
                with stage("merge"):
                    forest, state = sync_root_stats(forest, state, n_moves)
                n_syncs += 1
    with stage("summary"):
        synchronize(devices)
        dt = time.perf_counter() - t0
        if mesh is not None:
            forest = concat_members(forest, device)
            if metrics is not None:
                metrics = concat_members(metrics, device)
        if padded_members:
            forest = Tree(*(x[:E] for x in forest))
            if metrics is not None:
                metrics = type(metrics)(*(x[:E] for x in metrics))
        playouts = E * playouts_per_tree
        summary = forest_summary(forest, n_moves)
        stats = {
            "time_s": dt,
            "n_trees": E,
            "playouts": playouts,
            "playouts_per_tree": playouts_per_tree,
            "playouts_per_s": playouts / max(dt, 1e-9),
            "rounds": len(schedule),
            "grain": cfg.grain,
            "n_syncs": n_syncs,
            "sharded": mesh is not None,
            "n_devices": 1 if mesh is None else mesh.size,
            "mesh_shape": None if mesh is None else mesh_dims(mesh),
            "padded_members": padded_members,
            "tree_nodes": forest.n_nodes.cpu().tolist(),
            "member_best_moves": summary["member_best_moves"].cpu().tolist(),
            "member_root_values":
                summary["member_root_values"].cpu().tolist(),
            "best_move_sum": int(summary["best_move_sum"]),
            "best_move_vote": int(summary["best_move_vote"]),
        }
        if reused_nodes:
            stats["reused_nodes"] = reused_nodes
        if cfg.metrics:
            stats["metrics"] = summarize_metrics(metrics)
    return forest, stats


def check_forest_invariants(forest: Tree, *,
                            discrete_credits: bool = True) -> None:
    """Per-member structural invariants (host-side, used by tests)."""
    for e in range(forest_size(forest)):
        check_invariants(forest_member(forest, e),
                         discrete_credits=discrete_credits)
