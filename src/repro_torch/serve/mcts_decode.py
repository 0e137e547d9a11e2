"""GSCPM-guided LM decoding (port of ``repro.serve.mcts_decode``).

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
the rmsnorm kernel.

**B requests as one forest** (``mcts_decode_search_batch``,
``run_chunk_batch``, ``mcts_generate_batch``): B token trees in one
``core.tree.init_forest(B, ...)``, advanced together with no loop over
requests. Where the JAX package ``jax.vmap``s the single-request chunk, the
port runs the same helpers on forest-shaped arguments: every per-lane
tensor gains the member axis first ((B, W, ...)), node ids stay
member-local, and the tree ops reach a member's rows through
``core.tree``'s member offsets (``member_rows``, ``rows_view``,
``gather_nodes``). One descent level is ONE (B·W, C) ``uct_select`` tile
for all members. The KV cache is one flat batch of B·W rows — lane w of
request b is row b·W + w, as the reference's ``jnp.repeat(prompts, W,
axis=0)`` tiles it — and each row decodes at its own request's positions
(a (B·W,) position tensor, checked once per decode step). ``batch_extras``
(vlm patches) belongs to the non-dense families (ROADMAP.md item A12).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import scheduler as sched
from repro_torch.core import uct as uct_mod
from repro_torch.core.gscpm import (advance_paths, expand_batch,
                                    fold_task_keys, level_noise)
from repro_torch.core.root_parallel import fold_member_task_keys
from repro_torch.core.tree import (NO_NODE, Tree, best_child, child_stat_tile,
                                   forest_member, gather_nodes, init_forest,
                                   init_tree, member_rows, rows_view)
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
    read per level. Returns (paths (W, max_depth + 2), depths, leaves).

    On a forest (tree fields (B, cap + 1), ``noise_keys`` (B, W, 2)) every
    output gains the member axis first, with member-local node ids, and
    each level is still ONE ``uct_select`` call, on the (B·W, C) tile of
    all members' lanes: what ``jax.vmap(select_token_batch)`` returns."""
    cap = tree.cap
    C = tree.max_children
    shape = noise_keys.shape[:-1]                   # (W,) or (B, W)
    dev = noise_keys.device
    i32 = dict(dtype=torch.int32, device=dev)

    nodes = torch.zeros(shape, **i32)
    depths = torch.zeros(shape, **i32)
    paths = torch.full((*shape, cfg.max_depth + 2), cap, **i32)
    paths[..., 0] = 0
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    tile = lambda t: t.reshape(-1, C)
    while not bool(done.all()):
        n_kids = gather_nodes(tree, tree.n_children, nodes)
        fully = (n_kids >= cfg.branch) & (depths < cfg.max_depth)
        safe, valid, wins, visits, vloss, ptot = child_stat_tile(tree, nodes)
        noise = level_noise(noise_keys, depths, C, cfg.select_noise)
        picks = ops.uct_select(tile(wins), tile(visits), tile(vloss),
                               ptot.reshape(-1), tile(valid), cp,
                               noise=tile(noise), lane_mask=~done.reshape(-1))
        child = safe.gather(-1, picks.view(shape).long()[..., None])[..., 0]
        step = fully & ~done
        nodes = torch.where(step, child, nodes)
        paths = advance_paths(paths, depths, child, step)
        depths = torch.where(step, depths + 1, depths)
        done = done | ~step
    return paths, depths, nodes


def _select_token_paths(tree: Tree, cfg: MCTSDecodeConfig, cp,
                        noise_keys: torch.Tensor):
    """``select_token_path`` lane by lane (and member by member on a
    forest), stacked as ``select_token_batch`` returns them: the scalar
    oracle behind ``cfg.descent == "scalar"``."""
    if tree.parent.dim() == 2:
        per = [_select_token_paths(forest_member(tree, e), cfg, cp, k)
               for e, k in enumerate(noise_keys)]
        return tuple(torch.stack(x) for x in zip(*per))
    sel = [select_token_path(tree, cfg, k, cp) for k in noise_keys]
    return tuple(torch.stack(x) for x in zip(*sel))


def path_tokens(tree: Tree, paths: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Tokens along the paths (token of path[t+1]), 0-padded: (...,
    max_depth); on a forest ``paths`` has the member axis first."""
    toks = gather_nodes(tree, tree.move, paths[..., 1:max_depth + 1])
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
    (..., V) float32, ``depth`` (...), ``key`` (..., 2); on a forest the
    leading axes start with the member axis and ``leaf`` is member-local."""
    C = tree.max_children
    cap = tree.cap
    top_tok = top_k_tokens(leaf_logits, cfg.branch)               # (..., k)
    rows = member_rows(tree, leaf)
    slots = rows_view(tree, tree.children)[rows]                  # (..., C)
    valid = (torch.arange(C, dtype=torch.int32, device=leaf.device)
             < rows_view(tree, tree.n_children)[rows][..., None])
    tried = torch.where(
        valid, gather_nodes(tree, tree.move, torch.where(valid, slots, cap)),
        -1)
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

    On a forest (``paths`` (B, W, D) member-local, ``values`` and
    ``weights`` (B, W)) lane w of every member is added in one step: the
    members' rows never overlap, so each member still sees its lanes in
    order — the reference's scatter under ``vmap``, member by member — and
    the loop is W steps whatever B is. Every member's PAD row is zeroed.
    """
    D = paths.shape[-1]
    cap = tree.cap
    rows = member_rows(tree, paths)                    # (..., W, D)
    w = weights[..., None] * (paths != cap)
    rows_view(tree, tree.visits).index_add_(0, rows.reshape(-1),
                                            w.reshape(-1))
    contrib = w * values[..., None]
    wins = rows_view(tree, tree.wins)
    for lane in range(paths.shape[-2]):
        r = rows[..., lane, :]
        # repeated PAD entries all write their member's wins[cap] + 0: the
        # same value
        wins[r] = wins[r] + contrib[..., lane, :]
    tree.visits[..., cap] = 0.0
    tree.wins[..., cap] = 0.0
    return tree


# ---------------------------------------------------------- one iteration ----
def _row_positions(prompt_len, n_workers: int):
    """The decode position of every cache row at replay step 0: the Python
    int ``prompt_len`` (one request, every row alike), or, for a forest, the
    (B,) tensor of request lengths repeated over each request's W rows (row
    b·W + w is lane w of request b)."""
    if isinstance(prompt_len, int):
        return prompt_len
    return prompt_len.to(torch.int32).repeat_interleave(n_workers)


def _iteration(tree: Tree, params, mcfg: ModelConfig, cfg: MCTSDecodeConfig,
               cache, root_logits: torch.Tensor, prompt_len, cp,
               iter_keys: torch.Tensor, active: torch.Tensor,
               record: dict | None = None):
    """One batched GSCPM iteration of width W against the shared token
    tree. ``tree`` and ``cache`` are updated in place and returned.
    ``prompt_len`` is a run-time int (no shape depends on it but the cache
    size, fixed by the caller).

    On a forest of B token trees the same iteration advances every member
    at once: ``root_logits`` (B, V), ``prompt_len`` a (B,) int32 tensor,
    ``iter_keys`` (B, W, 2), ``active`` (B, W), and the cache holds B·W
    rows, each decoded at its own request's positions.

    ``record``, when given, receives the iteration's decisions — the
    descent's paths, the leaves' logits, the proposals and their gumbel
    noise, the rollout's first token, each rollout step's logits / T,
    sampling scores (logits / T + gumbel) and samples — so that two
    implementations can be held against each other decision by decision
    (the parity tests and ``parity.step_decode_search`` do)."""
    lanes = iter_keys.shape[:-1]                 # (W,) or (B, W)
    V = root_logits.shape[-1]
    pos0 = _row_positions(prompt_len, cfg.n_workers)

    noise_keys = rng.fold_in(iter_keys, 0)
    if cfg.descent == "scalar":
        paths, depths, leaves = _select_token_paths(tree, cfg, cp, noise_keys)
    else:
        paths, depths, leaves = select_token_batch(tree, cfg, cp, noise_keys)
    toks = path_tokens(tree, paths, cfg.max_depth).reshape(-1, cfg.max_depth)

    # --- replay the paths through the decode step (lockstep positions) ----
    leaf_logits = root_logits.unsqueeze(-2).expand(*lanes, V)
    for t in range(cfg.max_depth):
        logits, cache = api.decode(params, mcfg, toks[:, t:t + 1], pos0 + t,
                                   cache)
        leaf_logits = torch.where((depths == t + 1)[..., None],
                                  logits[:, 0, :].view(*lanes, V), leaf_logits)

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
    cols = torch.arange(paths.shape[-1], device=paths.device)
    paths = torch.where(
        cols == (depths + 1)[..., None],
        torch.where(expanded[..., None], new_ids[..., None], tree.cap), paths)

    # --- rollout: expanded token first, then sampled continuation --------
    start_pos = pos0 + cfg.max_depth   # the parked replay ends here
    tok = torch.where(expanded, torch.clamp(moves, min=0),
                      torch.argmax(leaf_logits, dim=-1).to(torch.int32))
    if record is not None:
        record.update(rollout_first=tok, rollout_logits=[])
    roll_keys = rng.fold_in(iter_keys, 2)
    logp_sum = torch.zeros(lanes, dtype=torch.float32, device=paths.device)
    for t in range(cfg.rollout_len):
        logits, cache = api.decode(params, mcfg, tok.reshape(-1, 1),
                                   start_pos + t, cache)
        logits = logits[:, 0, :].to(torch.float32).view(*lanes, V)
        logits_t = logits / max(cfg.temperature, 1e-6)
        step_key = rng.fold_in(roll_keys, t)
        nxt = rng.categorical(step_key, logits_t)
        if record is not None:
            record["rollout_logits"].append(logits_t)
            record["scores"].append(logits_t + rng.gumbel(step_key, V))
            record["samples"].append(nxt)
        logp = torch.log_softmax(logits, dim=-1)
        logp_sum = logp_sum + torch.gather(logp, -1, nxt[..., None])[..., 0]
        tok = nxt.to(torch.int32)
    values = torch.exp(logp_sum / cfg.rollout_len)             # (0, 1]
    tree = backup_values(tree, paths, values, active.to(torch.float32))
    return tree, cache


def run_chunk(tree: Tree, params, mcfg: ModelConfig, cfg: MCTSDecodeConfig,
              cache, root_logits, prompt_len, task_keys, active,
              m, cp) -> tuple[Tree, Any]:
    """``m`` sync iterations, one task grain per lane; tree and cache are
    updated in place. ``prompt_len``, ``m`` and ``cp`` are run-time values.
    Takes a forest's arguments too (``run_chunk_batch``)."""
    for i in range(int(m)):
        tree, cache = _iteration(tree, params, mcfg, cfg, cache, root_logits,
                                 prompt_len, cp, rng.fold_in(task_keys, i),
                                 active)
    return tree, cache


def run_chunk_batch(forest: Tree, params, mcfg: ModelConfig,
                    cfg: MCTSDecodeConfig, cache, root_logits, prompt_lens,
                    task_keys, active, m, cp) -> tuple[Tree, Any]:
    """``run_chunk`` for B concurrent requests: ``m`` sync iterations, each
    ONE pass for all B token trees. forest: B stacked trees; cache: B·W
    flat rows (lane w of request b at row b·W + w); root_logits (B, V);
    prompt_lens (B,) int32; task_keys (B, W, 2) and active (B, W); ``cp``
    shared by all requests. The forest and the cache are updated in place.

    The JAX package's ``cache_axes_def`` (where each cache leaf's (B, W)
    split sits for ``vmap``) has no counterpart: nothing is vmapped and the
    cache keeps its flat batch axis."""
    return run_chunk(forest, params, mcfg, cfg, cache, root_logits,
                     prompt_lens, task_keys, active, m, cp)


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


def _host_vector(x, B: int, default, dtype) -> np.ndarray:
    """A per-request argument as a host (B,) array (tensors are read once)."""
    if x is None:
        return np.full((B,), default, dtype)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    out = np.array(x, dtype).reshape(-1)         # a copy: callers reuse x
    if out.shape != (B,):
        raise ValueError(f"expected {B} per-request values, got {out.shape}")
    return out


def prefill_batch(params, mcfg: ModelConfig, prompts: torch.Tensor,
                  lens: torch.Tensor, n_workers: int, max_len: int):
    """The batched search's start: (root logits (B, V) float32, the B·W-row
    cache). prompts (B, P) left-aligned on the device, lens (B,) int32.

    Request-major tiling: lane w of request b sits at row b·W + w. The
    root logits are a decode at each request's true last position (the
    prefill's last-column logits would read a pad token for short rows);
    the rewrite of the last real token's KV is idempotent."""
    B, W = prompts.shape[0], n_workers
    _, cache = api.prefill(
        params, mcfg, {"tokens": prompts.repeat_interleave(W, dim=0)},
        max_len)
    last_tok = prompts[torch.arange(B, device=prompts.device), lens - 1]
    logits, cache = api.decode(params, mcfg,
                               last_tok.repeat_interleave(W)[:, None],
                               (lens - 1).repeat_interleave(W), cache)
    return logits.view(B, W, -1)[:, 0, :].to(torch.float32), cache


def mcts_decode_search_batch(params, mcfg: ModelConfig, prompts,
                             cfg: MCTSDecodeConfig, key: torch.Tensor, *,
                             prompt_lens=None, request_mask=None,
                             batch_extras: dict | None = None,
                             device=None) -> tuple[Tree, dict[str, Any]]:
    """Root-parallel GSCPM decode: B requests, B trees, one pass per sync
    iteration for all of them.

    prompts: (B, P) ids, left-aligned; rows shorter than P declare their
    true length in ``prompt_lens`` (pad tail tokens are never attended:
    root logits come from a decode at each request's own last real
    position, and every later decode masks positions beyond its cursor).
    ``request_mask`` (B,) bool masks whole requests: their lanes run dead,
    their trees stay at one node and their best token is -1 — the slot
    engine's empty-slot mechanism. Both are host values (a tensor is read
    once); the lengths must lie in [1, P], which keeps every decode
    position of the search inside the cache.

    Member b searches with the key ``fold_in(key, b)``, its lanes with
    ``fold_in(member key, task id)``. ``device=None`` means CUDA; ``params``
    must lie on that device. Returns the forest and stats: the reference's
    keys plus ``prefill_s`` (the padded prefill and the root decode) and
    ``sync_iterations``.
    """
    _check_in_slice(cfg, batch_extras)
    device = torch.device("cuda") if device is None else torch.device(device)
    prompts = torch.as_tensor(prompts).to(device=device, dtype=torch.int32)
    if prompts.dim() == 1:
        prompts = prompts[None, :]
    B, P = prompts.shape
    W = cfg.n_workers
    lens_np = _host_vector(prompt_lens, B, P, np.int32)
    mask_np = _host_vector(request_mask, B, True, bool)
    if not ((lens_np >= 1) & (lens_np <= P)).all():
        raise ValueError(f"prompt_lens {lens_np.tolist()} outside [1, {P}]")
    lens = torch.as_tensor(lens_np, device=device)
    mask = torch.as_tensor(mask_np, device=device)
    max_len = P + cfg.max_depth + cfg.rollout_len + 1
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    schedule = sched.make_schedule(
        cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler)
    cp = float(cfg.cp)

    sync()
    t_pf = time.perf_counter()
    root_logits, cache = prefill_batch(params, mcfg, prompts, lens, W,
                                       max_len)
    sync()
    prefill_s = time.perf_counter() - t_pf

    forest = init_forest(B, cfg.tree_cap, cfg.branch, 1, device=device)
    member_keys = fold_task_keys(key.to(device),
                                 torch.arange(B, dtype=torch.int32,
                                              device=device))
    t0 = time.perf_counter()
    playouts_per_req = 0
    for rnd in schedule:
        task_keys = fold_member_task_keys(member_keys, torch.as_tensor(
            rnd.task_ids, dtype=torch.int32, device=device))
        active = (torch.as_tensor(rnd.active, device=device)[None, :]
                  & mask[:, None])                                  # (B, W)
        forest, cache = run_chunk_batch(forest, params, mcfg, cfg, cache,
                                        root_logits, lens, task_keys, active,
                                        rnd.m, cp)
        playouts_per_req += int(rnd.active.sum()) * rnd.m
    sync()
    dt = time.perf_counter() - t0

    n_req = int(mask_np.sum())
    # the most-visited root child's token; a masked request's one-node tree
    # yields NO_NODE (-1)
    best = best_child(forest).cpu()
    playouts = n_req * playouts_per_req
    stats = {
        "time_s": dt,
        "n_requests": B,
        "n_active_requests": n_req,
        "playouts": playouts,
        "playouts_per_request": playouts_per_req,
        "playouts_per_s": playouts / max(dt, 1e-9),
        "grain": cfg.grain,
        "tree_nodes": forest.n_nodes.tolist(),
        "best_tokens": best.tolist(),
        "root_children": forest.n_children[:, 0].tolist(),
        "prefill_s": prefill_s,
        "sync_iterations": sum(int(r.m) for r in schedule),
    }
    return forest, stats


def mcts_generate_batch(params, mcfg: ModelConfig, prompts, prompt_lens,
                        n_tokens: int, cfg: MCTSDecodeConfig,
                        key: torch.Tensor, *, device=None,
                        keep_trees: bool = False
                        ) -> tuple[np.ndarray, np.ndarray, list]:
    """Lockstep multi-request generation: one batched search per emitted
    token (search ``i`` keyed ``fold_in(key, i)``), all requests committing
    together. The host token matrix keeps a fixed width of
    ``P0 + n_tokens``. Returns (tokens (B, P0 + n_tokens), lengths (B,),
    each search's stats, with its final forest under ``"forest"`` when
    ``keep_trees``), the first two as numpy arrays like the reference's."""
    device = torch.device("cuda") if device is None else torch.device(device)
    prompts = np.asarray(prompts, np.int32)
    B, P0 = prompts.shape
    lens = np.asarray(prompt_lens, np.int32).copy()
    buf = np.zeros((B, P0 + n_tokens), np.int32)
    buf[:, :P0] = prompts
    key = key.to(device)
    all_stats = []
    for i in range(n_tokens):
        forest, stats = mcts_decode_search_batch(
            params, mcfg, buf, cfg, rng.fold_in(key, i), prompt_lens=lens,
            device=device)
        toks = np.asarray(stats["best_tokens"], np.int32)
        buf[np.arange(B), lens] = toks
        lens += 1
        if keep_trees:
            stats["forest"] = forest
        all_stats.append(stats)
    return buf, lens, all_stats


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
