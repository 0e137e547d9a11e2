"""GSCPM-guided LM decoding (port of ``repro.serve.mcts_decode``, the
single-request half).

A search over token continuations is the paper's task of fungible
iterations: ``n_playouts`` UCT iterations in ``n_tasks`` grains, run by
``n_workers`` lanes against ONE shared token tree, scheduled by the same
``core.scheduler`` disciplines as the Hex search. Per sync iteration:

- *selection*: the level-synchronous batched descent of the Hex search, one
  ``kernels.ops.uct_select`` (W, C) tile per level with C = ``branch``;
  one host read per level, at most ``max_depth + 1`` levels;
- *replay*: every lane's path is decoded through the model at positions
  ``prompt_len .. prompt_len + max_depth - 1``, shallow paths padded with
  token 0 (as the reference does), rewriting the shared (W, Smax) cache in
  place;
- *expansion*: an untried token among the leaf's top-``branch`` logits
  (ties to the lower token id, as ``lax.top_k``), batch-deduped by
  ``core.gscpm.expand_batch``;
- *rollout*: ``rollout_len`` sampled tokens from position
  ``prompt_len + max_depth``; the value is exp(mean log-prob) in (0, 1];
- *backup*: visits by ``index_add_`` (weights 0/1: exact in any order),
  wins in a fixed order — lane by lane, as XLA's sequential scatter-add
  adds them — so a search is bit-identical run to run on the card.

The prompt is prefilled once per search, tiled over the W lanes; on the
card prefill runs the flash-attention kernel (``use_flash``) and every norm
the rmsnorm kernel. Out of this slice: ``mcts_decode_search_batch``,
``run_chunk_batch`` and ``mcts_generate_batch`` need the root-parallel
forest (ROADMAP.md item A7); ``batch_extras`` (vlm patches) the non-dense
families (A12).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch import rng
from repro_torch.core import scheduler as sched
from repro_torch.core import uct as uct_mod
from repro_torch.core.gscpm import (advance_paths, expand_batch,
                                    fold_task_keys, level_noise)
from repro_torch.core.tree import (NO_NODE, Tree, best_child, child_stat_tile,
                                   init_tree)
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class MCTSDecodeConfig:
    """Fields marked compare=False are excluded from hash/eq, as in the JAX
    package: ``cp`` and the playout/task/scheduler knobs only shape the
    host-side schedule."""

    n_playouts: int = dataclasses.field(default=128, compare=False)
    # the grain dial: m = n_playouts / n_tasks
    n_tasks: int = dataclasses.field(default=16, compare=False)
    n_workers: int = 8           # lanes through the LM
    cp: float = dataclasses.field(default=1.0, compare=False)
    branch: int = 8              # children per node = top-k tokens
    max_depth: int = 6           # tree horizon in tokens
    rollout_len: int = 8
    temperature: float = 1.0
    select_noise: float = 1e-3
    tree_cap: int = 2048
    scheduler: str = dataclasses.field(default="fifo", compare=False)
    descent: str = "batched"     # batched (level-synchronous) | scalar (oracle)

    @property
    def grain(self) -> int:
        return max(1, self.n_playouts // max(1, self.n_tasks))


# ------------------------------------------------------------- selection ----
def select_token_path(tree: Tree, cfg: MCTSDecodeConfig,
                      noise_key: torch.Tensor, cp=None):
    """UCT descent of one lane to a not-fully-expanded node (single-agent
    values): the scalar oracle of ``select_token_batch``. Returns
    (path (max_depth + 2,), depth, node)."""
    cap = tree.cap
    C = tree.max_children
    dev = tree.device
    cp = cfg.cp if cp is None else cp
    path = torch.full((cfg.max_depth + 2,), cap, dtype=torch.int32, device=dev)
    path[0] = 0
    node, depth = 0, 0
    slots_ids = torch.arange(C, dtype=torch.int32, device=dev)
    while True:
        n_kids = int(tree.n_children[node])
        if not (n_kids >= cfg.branch and depth < cfg.max_depth):
            break
        valid = slots_ids < n_kids
        safe = torch.where(valid, tree.children[node], cap)
        scores = uct_mod.uct_scores(
            tree.wins[safe], tree.visits[safe], tree.vloss[safe],
            tree.visits[node] + tree.vloss[node], cp, valid)
        noise = cfg.select_noise * rng.uniform(rng.fold_in(noise_key, depth), C)
        node = int(safe[uct_mod.select_child(scores, noise)])
        depth += 1
        path[depth] = node
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return path, i32(depth), i32(node)


def select_token_batch(tree: Tree, cfg: MCTSDecodeConfig, cp,
                       noise_keys: torch.Tensor):
    """Level-synchronous batched descent over the token tree: all W lanes
    step down in lockstep, one ``kernels.ops.uct_select`` (W, C) tile per
    level, finished lanes masked and held. Bit-identical to
    ``select_token_path`` per lane under the same RNG schedule. One host
    read per level. Returns (paths (W, max_depth + 2), depths, leaves)."""
    cap = tree.cap
    C = tree.max_children
    W = noise_keys.shape[0]
    dev = noise_keys.device

    nodes = torch.zeros((W,), dtype=torch.int32, device=dev)
    depths = torch.zeros((W,), dtype=torch.int32, device=dev)
    paths = torch.full((W, cfg.max_depth + 2), cap, dtype=torch.int32,
                       device=dev)
    paths[:, 0] = 0
    done = torch.zeros((W,), dtype=torch.bool, device=dev)
    lanes = torch.arange(W, device=dev)
    while not bool(done.all()):
        n_kids = tree.n_children[nodes]
        fully = (n_kids >= cfg.branch) & (depths < cfg.max_depth)
        safe, valid, wins, visits, vloss, ptot = child_stat_tile(tree, nodes)
        noise = level_noise(noise_keys, depths, C, cfg.select_noise)
        picks = ops.uct_select(wins, visits, vloss, ptot, valid, cp,
                               noise=noise, lane_mask=~done)
        child = safe[lanes, picks]
        step = fully & ~done
        nodes = torch.where(step, child, nodes)
        paths = advance_paths(paths, depths, child, step)
        depths = torch.where(step, depths + 1, depths)
        done = done | ~step
    return paths, depths, nodes


def path_tokens(tree: Tree, paths: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Tokens along the paths (token of path[t+1]), 0-padded: (..., max_depth)."""
    toks = tree.move[paths[..., 1:max_depth + 1]]
    return torch.clamp(toks, min=0).to(torch.int32)


def top_k_tokens(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(..., V) -> (..., k) int32 token ids of the k largest logits, larger
    first and the LOWER id first among equal logits (``lax.top_k``'s order;
    ``torch.topk`` leaves the order of ties unspecified, a stable sort does
    not)."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def propose_token(tree: Tree, leaf: torch.Tensor, leaf_logits: torch.Tensor,
                  cfg: MCTSDecodeConfig, depth: torch.Tensor,
                  key: torch.Tensor) -> torch.Tensor:
    """Random untried token among each leaf's top-``branch`` logits (-1:
    none). Batched over leading axes: ``leaf`` (...), ``leaf_logits``
    (..., V) float32, ``depth`` (...), ``key`` (..., 2)."""
    C = tree.max_children
    cap = tree.cap
    top_tok = top_k_tokens(leaf_logits, cfg.branch)               # (..., k)
    slots = tree.children[leaf]                                   # (..., C)
    valid = (torch.arange(C, dtype=torch.int32, device=leaf.device)
             < tree.n_children[leaf][..., None])
    tried = torch.where(valid, tree.move[torch.where(valid, slots, cap)], -1)
    is_tried = (top_tok[..., :, None] == tried[..., None, :]).any(dim=-1)
    can = ~is_tried & (depth < cfg.max_depth)[..., None]
    g = rng.gumbel(key, cfg.branch)
    pick = torch.argmax(torch.where(can, g, -torch.inf), dim=-1, keepdim=True)
    tok = torch.gather(top_tok, -1, pick)[..., 0]
    return torch.where(can.any(dim=-1), tok, NO_NODE).to(torch.int32)


# ----------------------------------------------------------------- backup ----
def backup_values(tree: Tree, paths: torch.Tensor, values: torch.Tensor,
                  weights: torch.Tensor) -> Tree:
    """Single-agent backup: every node on a lane's path gains the lane's
    weight in visits and weight * value in wins. IN PLACE.

    Visits add 0 or 1, exact in any order, so one ``index_add_``. Wins add
    floats, whose sum depends on the order: CUDA's atomics would make two
    runs differ. They are added lane by lane instead — the order of XLA's
    sequential scatter-add over the flattened paths, since a node appears at
    most once in a lane's path — which is deterministic on the card and
    reproduces the reference's rounding on the CPU.
    """
    W, D = paths.shape
    cap = tree.cap
    flat = paths.reshape(-1)
    w = weights.repeat_interleave(D) * (flat != cap)
    tree.visits.index_add_(0, flat, w)
    contrib = (w * values.repeat_interleave(D)).reshape(W, D)
    for lane in range(W):
        p = paths[lane]
        # repeated PAD entries all write wins[cap] + 0: the same value
        tree.wins[p] = tree.wins[p] + contrib[lane]
    tree.visits[cap] = 0.0
    tree.wins[cap] = 0.0
    return tree


# ---------------------------------------------------------- one iteration ----
def _iteration(tree: Tree, params, mcfg: ModelConfig, cfg: MCTSDecodeConfig,
               cache, root_logits: torch.Tensor, prompt_len: int, cp,
               iter_keys: torch.Tensor, active: torch.Tensor,
               record: dict | None = None):
    """One batched GSCPM iteration of width W against the shared token
    tree. ``tree`` and ``cache`` are updated in place and returned.
    ``prompt_len`` is a run-time int (no shape depends on it but the cache
    size, fixed by the caller).

    ``record``, when given, receives the iteration's decisions — the
    descent's paths, the leaves' logits, the proposals and their gumbel
    noise, the rollout's first token, each rollout step's logits / T,
    sampling scores (logits / T + gumbel) and samples — so that two
    implementations can be held against each other decision by decision
    (the parity tests and ``parity.step_decode_search`` do)."""
    W = cfg.n_workers
    V = root_logits.shape[-1]

    noise_keys = rng.fold_in(iter_keys, 0)
    if cfg.descent == "scalar":
        sel = [select_token_path(tree, cfg, noise_keys[w], cp) for w in range(W)]
        paths, depths, leaves = (torch.stack(x) for x in zip(*sel))
    else:
        paths, depths, leaves = select_token_batch(tree, cfg, cp, noise_keys)
    toks = path_tokens(tree, paths, cfg.max_depth)

    # --- replay the paths through the decode step (lockstep positions) ----
    leaf_logits = root_logits.expand(W, V)
    for t in range(cfg.max_depth):
        logits, cache = api.decode(params, mcfg, toks[:, t:t + 1],
                                   prompt_len + t, cache)
        leaf_logits = torch.where((depths == t + 1)[:, None],
                                  logits[:, 0, :], leaf_logits)

    # --- expansion (dedup batch insert, same allocator as Hex) ------------
    k_prop = rng.fold_in(iter_keys, 1)
    moves = propose_token(tree, leaves, leaf_logits, cfg, depths, k_prop)
    if record is not None:
        record.update(paths=paths.clone(), leaf_logits=leaf_logits,
                      top=top_k_tokens(leaf_logits, cfg.branch), moves=moves,
                      gumbel=rng.gumbel(k_prop, cfg.branch), scores=[],
                      samples=[])
    tree, new_ids = expand_batch(tree, leaves, moves, active)
    expanded = new_ids < tree.cap
    cols = torch.arange(paths.shape[1], device=paths.device)[None, :]
    paths = torch.where(
        cols == (depths + 1)[:, None],
        torch.where(expanded[:, None], new_ids[:, None], tree.cap), paths)

    # --- rollout: expanded token first, then sampled continuation --------
    start_pos = prompt_len + cfg.max_depth   # the parked replay ends here
    tok = torch.where(expanded, torch.clamp(moves, min=0),
                      torch.argmax(leaf_logits, dim=-1).to(torch.int32))
    if record is not None:
        record.update(rollout_first=tok, rollout_logits=[])
    roll_keys = rng.fold_in(iter_keys, 2)
    logp_sum = torch.zeros((W,), dtype=torch.float32, device=paths.device)
    for t in range(cfg.rollout_len):
        logits, cache = api.decode(params, mcfg, tok[:, None], start_pos + t,
                                   cache)
        logits = logits[:, 0, :].to(torch.float32)
        logits_t = logits / max(cfg.temperature, 1e-6)
        step_key = rng.fold_in(roll_keys, t)
        nxt = rng.categorical(step_key, logits_t)
        if record is not None:
            record["rollout_logits"].append(logits_t)
            record["scores"].append(logits_t + rng.gumbel(step_key, V))
            record["samples"].append(nxt)
        logp = torch.log_softmax(logits, dim=-1)
        logp_sum = logp_sum + torch.gather(logp, 1, nxt[:, None])[:, 0]
        tok = nxt.to(torch.int32)
    values = torch.exp(logp_sum / cfg.rollout_len)             # (0, 1]
    tree = backup_values(tree, paths, values, active.to(torch.float32))
    return tree, cache


def run_chunk(tree: Tree, params, mcfg: ModelConfig, cfg: MCTSDecodeConfig,
              cache, root_logits, prompt_len: int, task_keys, active,
              m, cp) -> tuple[Tree, Any]:
    """``m`` sync iterations, one task grain per lane; tree and cache are
    updated in place. ``prompt_len``, ``m`` and ``cp`` are run-time values."""
    for i in range(int(m)):
        tree, cache = _iteration(tree, params, mcfg, cfg, cache, root_logits,
                                 prompt_len, cp, rng.fold_in(task_keys, i),
                                 active)
    return tree, cache


def run_chunk_batch(*args, **kw):
    raise NotImplementedError(
        "run_chunk_batch: B concurrent token trees need the root-parallel "
        "forest, not ported yet (ROADMAP.md item A7)")


# ------------------------------------------------------------------ driver ----
def _check_in_slice(cfg: MCTSDecodeConfig, batch_extras) -> None:
    if batch_extras:
        raise NotImplementedError(
            "batch_extras: the vlm prefix inputs are not ported (ROADMAP.md "
            "item A12)")
    if cfg.descent not in ("batched", "scalar"):
        raise ValueError(f"unknown descent {cfg.descent!r}")


def mcts_decode_search(params, mcfg: ModelConfig, prompt, cfg: MCTSDecodeConfig,
                       key: torch.Tensor, batch_extras: dict | None = None, *,
                       device=None) -> tuple[Tree, dict[str, Any]]:
    """One GSCPM search for the best next token after ``prompt`` (1-D ids).

    ``device=None`` means CUDA; ``params`` must lie on that device.
    Returns the final tree and stats; besides
    the reference's keys, the stats hold ``prefill_s`` and
    ``sync_iterations``.
    """
    _check_in_slice(cfg, batch_extras)
    device = torch.device("cuda") if device is None else torch.device(device)
    prompt = torch.as_tensor(prompt).to(device=device, dtype=torch.int32)
    prompt = prompt.reshape(-1)
    key = key.to(device)
    prompt_len = int(prompt.shape[0])
    max_len = prompt_len + cfg.max_depth + cfg.rollout_len + 1
    W = cfg.n_workers
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    schedule = sched.make_schedule(
        cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler)
    cp = float(cfg.cp)

    sync()
    t_pf = time.perf_counter()
    # every lane gets its own copy of the prompt's KV
    root_logits, cache = api.prefill(
        params, mcfg, {"tokens": prompt[None, :].repeat(W, 1)}, max_len)
    root_logits = root_logits[0, 0].to(torch.float32)
    sync()
    prefill_s = time.perf_counter() - t_pf

    tree = init_tree(cfg.tree_cap, cfg.branch, 1, device=device)
    t0 = time.perf_counter()
    playouts = 0
    for rnd in schedule:
        task_keys = fold_task_keys(key, torch.as_tensor(
            rnd.task_ids, dtype=torch.int32, device=device))
        active = torch.as_tensor(rnd.active, device=device)
        tree, cache = run_chunk(tree, params, mcfg, cfg, cache, root_logits,
                                prompt_len, task_keys, active, rnd.m, cp)
        playouts += int(rnd.active.sum()) * rnd.m
    sync()
    dt = time.perf_counter() - t0

    stats = {
        "time_s": dt,
        "playouts": playouts,
        "playouts_per_s": playouts / max(dt, 1e-9),
        "tree_nodes": int(tree.n_nodes),
        "best_token": int(best_child(tree)),
        "grain": cfg.grain,
        "root_children": int(tree.n_children[0]),
        "prefill_s": prefill_s,
        "sync_iterations": sum(int(r.m) for r in schedule),
    }
    return tree, stats


def mcts_decode_search_batch(*args, **kw):
    raise NotImplementedError(
        "mcts_decode_search_batch: B concurrent requests need the "
        "root-parallel forest, not ported yet (ROADMAP.md item A7)")


def mcts_generate_batch(*args, **kw):
    raise NotImplementedError(
        "mcts_generate_batch: runs on mcts_decode_search_batch, which needs "
        "the root-parallel forest (ROADMAP.md item A7)")


def mcts_generate(params, mcfg: ModelConfig, prompt, n_tokens: int,
                  cfg: MCTSDecodeConfig, key: torch.Tensor,
                  batch_extras: dict | None = None, *, device=None,
                  keep_trees: bool = False) -> tuple[torch.Tensor, list]:
    """Emit ``n_tokens``, one GSCPM search per token (search, then commit
    the most-visited root child), search ``i`` keyed ``fold_in(key, i)``.
    Returns the prompt with the tokens appended, and each search's stats
    (with its final tree under ``"tree"`` when ``keep_trees``)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    toks = torch.as_tensor(prompt).to(device=device, dtype=torch.int32)
    all_stats = []
    for i in range(n_tokens):
        tree, stats = mcts_decode_search(
            params, mcfg, toks, cfg, rng.fold_in(key.to(device), i),
            batch_extras, device=device)
        toks = torch.cat([toks, torch.tensor([stats["best_token"]],
                                             dtype=torch.int32, device=device)])
        if keep_trees:
            stats["tree"] = tree
        all_stats.append(stats)
    return toks, all_stats
