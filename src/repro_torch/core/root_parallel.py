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

On one card the ensemble axis is not sharded: ``shard="auto"`` and
``"off"`` take the one-device arm and ``"require"`` raises, as the JAX
package does when it sees one device. The multi-card arm
(``ensemble_mesh``, ``ensemble_spec``, ``ensemble_sharding``,
``_sharded_chunk``, ``_sharded_chunk_metrics``) is not ported yet
(ROADMAP.md item A7, its multi-card row): on one device the helpers answer
as the JAX package's do, anything that would shard raises.
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
    _check_in_slice,
    fold_task_keys,
    run_chunk,
    warm_tree_check,
)
from repro_torch.core.tree import (
    Tree,
    _root_children,
    best_child,
    check_invariants,
    forest_member,
    forest_size,
    init_forest,
    root_move_stats,
    root_value,
)
from repro_torch.kernels import ops

_MULTI_CARD = ("the multi-card ensemble arm (an 'ens' mesh, the forest "
               "sharded over it) is not ported yet (ROADMAP.md item A7, its "
               "multi-card row)")


# ----------------------------------------------------------- forest chunk ----
def _forest_chunk(forest: Tree, boards: torch.Tensor, cfg: GSCPMConfig,
                  task_keys: torch.Tensor, active: torch.Tensor,
                  m, cp, metrics=None):
    """``gscpm.run_chunk`` on a forest: ``m`` sync iterations, each ONE pass
    for all E members (boards (E, n), task_keys (E, W, 2), active (E, W)).
    All members share the round's grain ``m`` and ``cp``; per-member RNG
    streams keep their searches decorrelated. Updates the forest in place
    and returns it. ``cfg.metrics`` is not ported yet (ROADMAP.md item
    A9)."""
    _check_in_slice(cfg, metrics=metrics)
    return run_chunk(forest, boards, cfg, task_keys, active, m, cp)


run_chunk_forest = _forest_chunk


def ensemble_mesh(devices=None):
    """The 1-D ensemble mesh over the visible devices: None on one device,
    as in the JAX package; more than one raises (not ported yet)."""
    if devices is None:
        devices = list(range(torch.cuda.device_count()))
    if len(devices) <= 1:
        return None
    raise NotImplementedError(f"ensemble_mesh: {_MULTI_CARD}")


def ensemble_spec(mesh):
    """The member axis' placement on an ensemble mesh (not ported yet)."""
    raise NotImplementedError(f"ensemble_spec: {_MULTI_CARD}")


def ensemble_sharding(n_trees: int, mesh=None):
    """(sharding over the ensemble axis, padded member count): ``(None,
    n_trees)`` with fewer than two devices, as in the JAX package."""
    mesh = ensemble_mesh() if mesh is None else mesh
    if mesh is None:
        return None, n_trees
    raise NotImplementedError(f"ensemble_sharding: {_MULTI_CARD}")


def _sharded_chunk(*args, **kwargs):
    raise NotImplementedError(f"_sharded_chunk: {_MULTI_CARD}")


def _sharded_chunk_metrics(*args, **kwargs):
    raise NotImplementedError(f"_sharded_chunk_metrics: {_MULTI_CARD}")


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


def run_schedule_round_forest(forest: Tree, boards: torch.Tensor,
                              cfg: GSCPMConfig, member_keys: torch.Tensor,
                              rnd: sched.Round, cp, metrics=None, *,
                              n_real: int | None = None, mesh=None):
    """Forest twin of ``gscpm.run_schedule_round``: one schedule ``Round``
    for all E members — the quantum unit shared by the batch driver
    (``gscpm_search_batch``) and a serving engine. Round RNG depends only
    on (member key, task id, iteration), never on padding or wall-clock
    interleaving.

    ``n_real`` masks pad members (rows ``>= n_real`` run with all-False
    ``active`` — bitwise inert). ``mesh`` (the multi-card arm) is not
    ported yet. The forest is updated in place and returned.
    """
    if mesh is not None:
        raise NotImplementedError(f"run_schedule_round_forest(mesh=): "
                                  f"{_MULTI_CARD}")
    Ep = forest_size(forest)
    dev = boards.device
    task_keys = fold_member_task_keys(
        member_keys, torch.as_tensor(rnd.task_ids, dtype=torch.int32,
                                     device=dev))
    act = np.tile(np.asarray(rnd.active)[None, :], (Ep, 1))
    if n_real is not None and n_real < Ep:
        act[n_real:] = False
    active = torch.as_tensor(act, device=dev)
    return run_chunk_forest(forest, boards, cfg, task_keys, active,
                            int(rnd.m), cp, metrics)


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


def sync_root_stats(forest: Tree, state: RootSyncState, n_moves: int
                    ) -> tuple[Tree, RootSyncState]:
    """Refresh every member's root stats with the other members' own work.

    After the call, member e's root child for move a holds
    ``own_e(a) + Σ_{e'≠e} own_e'(a)`` — for the moves e has expanded; moves a
    member has not discovered receive nothing (it cannot host a child row
    for them), which is the standard root-parallel partial-merge semantics.
    Every statistic is a sum of half-integers, so the float32 sums are
    exact. Writes into the forest in place; returns it and the new state.
    """
    cap = forest.cap
    dense_v, dense_w = root_move_stats(forest, n_moves)
    own_v = dense_v - state.visits            # (E, M) each member's own work
    own_w = dense_w - state.wins
    new_f_v = own_v.sum(dim=0)[None, :] - own_v   # Σ others' own
    new_f_w = own_w.sum(dim=0)[None, :] - own_w
    own_rv = forest.visits[:, 0] - state.root_visits
    own_rw = forest.wins[:, 0] - state.root_wins
    new_f_rv = own_rv.sum() - own_rv
    new_f_rw = own_rw.sum() - own_rw

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
    boards batch; the schedule stays exactly ``cfg``'s, and the forest's
    tensors are updated in place (when they already lie on ``device``).

    ``device=None`` means ``torch.device("cuda")``. ``shard``: ``"auto"``
    and ``"off"`` run the one-device arm; ``"require"`` raises (the
    multi-card arm is not ported yet). ``tracer`` and ``cfg.metrics`` are
    not ported yet (ROADMAP.md item A9). ``plain_kernels=True`` runs the
    whole search with the kernels' plain versions even on the card (a
    comparison mode).
    """
    _check_in_slice(cfg, tracer)
    device = torch.device("cuda") if device is None else torch.device(device)
    boards = torch.as_tensor(boards).to(device=device, dtype=torch.int8)
    if boards.dim() == 1:
        if n_trees is None and forest is not None:
            n_trees = forest_size(forest)   # warm restart implies E
        boards = boards[None, :].expand(n_trees or 1, -1)
    boards = boards.contiguous()
    E = boards.shape[0]
    if n_trees is not None and n_trees != E:
        raise ValueError(f"n_trees={n_trees} != boards.shape[0]={E}")
    if shard not in ("auto", "off", "require"):
        raise ValueError(f"shard must be 'auto'|'off'|'require', "
                         f"got {shard!r}")
    n_moves = cfg.game_obj.n_actions  # the Game seam's move-id space
    key = key.to(device)

    reused_nodes = 0
    if forest is None:
        forest = init_forest(E, cfg.tree_cap, n_moves, to_move, device=device)
    else:
        if forest_size(forest) != E:
            raise ValueError(
                f"warm forest has {forest_size(forest)} members, "
                f"boards batch has {E}")
        forest = Tree(*(t.to(device) for t in forest))
        tm = int(torch.as_tensor(to_move).reshape(-1)[0])
        warm_tree_check(forest, tm, cfg)
        reused_nodes = int(forest.n_nodes.sum()) - E
    if shard == "require":
        raise RuntimeError(
            "shard='require' but the port runs the ensemble on one device: "
            f"{_MULTI_CARD}")
    member_keys = fold_task_keys(
        key, torch.arange(E, dtype=torch.int32, device=device))
    schedule = sched.make_schedule(
        cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler)
    state = init_sync_state(E, n_moves, device) if merge_every > 0 else None

    cp = float(cfg.cp)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    playouts_per_tree = 0
    n_syncs = 0
    with ops.plain_versions() if plain_kernels else contextlib.nullcontext():
        for r, rnd in enumerate(schedule):
            forest = run_schedule_round_forest(forest, boards, cfg,
                                               member_keys, rnd, cp, n_real=E)
            playouts_per_tree += int(rnd.active.sum()) * rnd.m
            if merge_every > 0 and ((r + 1) % merge_every == 0
                                    or r == len(schedule) - 1):
                forest, state = sync_root_stats(forest, state, n_moves)
                n_syncs += 1
    sync()
    dt = time.perf_counter() - t0

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
        "sharded": False,
        "n_devices": 1,
        "mesh_shape": None,
        "padded_members": 0,
        "tree_nodes": forest.n_nodes.cpu().tolist(),
        "member_best_moves": summary["member_best_moves"].cpu().tolist(),
        "member_root_values": summary["member_root_values"].cpu().tolist(),
        "best_move_sum": int(summary["best_move_sum"]),
        "best_move_vote": int(summary["best_move_vote"]),
    }
    if reused_nodes:
        stats["reused_nodes"] = reused_nodes
    return forest, stats


def check_forest_invariants(forest: Tree, *,
                            discrete_credits: bool = True) -> None:
    """Per-member structural invariants (host-side, used by tests)."""
    for e in range(forest_size(forest)):
        check_invariants(forest_member(forest, e),
                         discrete_credits=discrete_credits)
