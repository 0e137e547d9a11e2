"""Mixture-of-Experts layer: top-k router, shared + routed experts, grouped
capacity-limited dispatch (port of ``repro.models.moe``).

The dispatch is the JAX package's, step for step, so that the same tokens
are dropped: tokens split into G groups of ``gs``; per group the (token,
choice) assignments are sorted by expert with a STABLE sort (first come,
first served within an expert), each gets its rank within its expert, and
ranks at or past the capacity C go to the drop row ``E*C``. The (E, C)
slots are filled by one gather from the inverted slot -> token index, the
expert FFNs run as one batched product over the expert axis, and each
token's k results are gathered back and summed in choice order, a dropped
choice's combine weight zeroed.

Sharded, the reference's five annotations are ``shard`` calls — the
groups over ``expert_group`` (data), the slot index and the expert buffers
over ``expert`` (model) as well — and three regions run on each rank's
shards (``sharding.rules.local_region``), bounded by those annotations:
the routing and dispatch plan (a stable sort, ``cummax`` and scatters,
which DTensor has no strategy for; group-local), the gather of each
expert's slots from its group's tokens (a rank gathers only its own
experts' rows: the buffer is born split over experts, no all-to-all), and
the combine (each rank gathers the choices that landed on its experts,
zeros elsewhere, and the sum over the expert split is all-reduced).

Covers DeepSeek-V2 (2 shared + 160 routed, top-6, softmax gate) and
Qwen3-MoE (128 routed, top-8, normalized top-k probs). The Switch-style
load-balance loss (``aux_load_balance_loss``) is ported with its reference,
which no loss of either package adds.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import ModelConfig, Spec, activation
from repro_torch.models.layers import mlp, mlp_specs
from repro_torch.sharding import rules as shr
from repro_torch.sharding.rules import shard


def moe_specs(cfg: ModelConfig) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    s = {
        "router": Spec((d, E), ("embed", None), 1.0 / math.sqrt(d)),
        "wg": Spec((E, d, ff), ("expert", "embed", "mlp"), 1.0 / math.sqrt(d)),
        "wu": Spec((E, d, ff), ("expert", "embed", "mlp"), 1.0 / math.sqrt(d)),
        "wd": Spec((E, ff, d), ("expert", "mlp", "embed"), 1.0 / math.sqrt(ff)),
    }
    if cfg.n_shared_experts > 0:
        # shared experts fused into one wider MLP (DeepSeek-V2 style)
        s["shared"] = mlp_specs(cfg, d_ff=cfg.n_shared_experts * ff)
    return s


def router_topk(logits: torch.Tensor, k: int, norm_topk: bool):
    """(..., E) logits -> (..., k) int32 indices + float32 combine weights.
    ``lax.top_k``'s order: descending, the lower expert first on a tie
    (a stable descending sort)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    if norm_topk:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topi.to(torch.int32), topv


def capacity(tokens: int, k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(tokens * k * factor / n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 (the TPU's lane alignment)


def n_groups(T: int, group_size: int) -> int:
    """Dispatch group count: ~group_size tokens per group, G | T, G <= 256."""
    target = max(1, min(256, T // min(group_size, T)))
    for g in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if g <= target and T % g == 0:
            return g
    return 1


def dispatch(topi: torch.Tensor, E: int, C: int):
    """The grouped dispatch plan. topi: (G, gs, k) expert choices ->
    (inv (G, E, C): the token in each expert slot, ``gs`` for an empty
    slot; slot_by_token (G, gs, k): each choice's slot, ``E*C`` if
    dropped)."""
    G, gs, k = topi.shape
    dev = topi.device
    flat_e = topi.reshape(G, gs * k).long()
    order = torch.argsort(flat_e, dim=1, stable=True)       # FIFO per expert
    sorted_e = torch.gather(flat_e, 1, order)
    idx = torch.arange(gs * k, device=dev).expand(G, -1)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    pos_in_e = idx - start_idx                              # rank in expert
    slot = torch.where(pos_in_e < C, sorted_e * C + pos_in_e, E * C)
    token_sorted = order // k
    inv = torch.full((G, E * C + 1), gs, dtype=torch.long, device=dev)
    # the drop row E*C collects the dropped choices and is cut off
    inv.scatter_(1, slot, token_sorted)
    inv = inv[:, :E * C].reshape(G, E, C)
    slot_by_token = torch.zeros_like(slot).scatter_(1, order, slot)
    return inv, slot_by_token.reshape(G, gs, k)


def moe_ffn(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Routed top-k experts (+ shared experts)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    T = B * S
    G = n_groups(T, cfg.moe_group_size)
    gs = T // G
    C = capacity(gs, k, E, cfg.capacity_factor)
    dt = x.dtype
    act = activation(cfg.act)

    xg = shard(x.reshape(G, gs, d), ("expert_group", None, None))
    logits = xg @ params["router"].to(dt)                    # (G, gs, E)
    if isinstance(xg, DTensor):
        yg = _moe_sharded(params, cfg, xg, logits, E, k, C)
    else:
        topw, inv, slot_by_token = _plan(logits, cfg, E, k, C)
        buf = _gather_slots(xg, inv)
        out_buf = _experts(params, act, buf, dt)
        yg = _combine(out_buf, slot_by_token, topw, E, C)
    y = yg.reshape(B, S, d)

    if cfg.n_shared_experts > 0:
        y = y + mlp(params["shared"], cfg, x)
    return y


def _plan(logits, cfg: ModelConfig, E: int, k: int, C: int):
    """Routing and the dispatch plan of (G, gs, E) logits: (combine
    weights, inv, slot_by_token), as ``router_topk`` and ``dispatch``."""
    topi, topw = router_topk(logits, k, cfg.norm_topk_prob)  # (G, gs, k)
    inv, slot_by_token = dispatch(topi, E, C)
    return topw, inv, slot_by_token


def _gather_slots(xg, inv):
    """The dispatch: each expert slot's token row gathered from its group's
    tokens (G, gs, d) and a zero row (the empty slots' index ``gs``), one
    gather -> (G, E', C, d) for the experts ``inv`` (G, E', C) covers."""
    G, _, d = xg.shape
    xg_pad = torch.cat([xg, torch.zeros((G, 1, d), dtype=xg.dtype,
                                        device=xg.device)], dim=1)
    g_idx = torch.arange(G, device=xg.device)[:, None, None]
    return xg_pad[g_idx, inv]


def _experts(params, act, buf, dt):
    """The expert FFNs over (G, E, C, d) slots: one batched product over
    the expert axis."""
    G, E, C, d = buf.shape
    be = buf.permute(1, 0, 2, 3).reshape(E, G * C, d)
    h = act(torch.bmm(be, params["wg"].to(dt))) * torch.bmm(be, params["wu"].to(dt))
    out_buf = torch.bmm(h, params["wd"].to(dt))              # (E, G*C, d)
    return out_buf.reshape(E, G, C, d).permute(1, 0, 2, 3)


def _combine(out_buf, slot_by_token, topw, E: int, C: int,
             e_axes: tuple[str, ...] = ()):
    """The combine: each token's k expert results gathered from
    ``out_buf`` (G, E', C, d) and summed in choice order, a dropped
    choice's weight zeroed. With the experts split over the LM mesh's
    ``e_axes`` (inside a region), ``out_buf`` holds this rank's E' experts
    only: a choice of another rank's expert weighs 0 here, and the sum over
    the split is all-reduced."""
    G, El, _, d = out_buf.shape
    gs, k = slot_by_token.shape[1:]
    dt = out_buf.dtype
    dropped = slot_by_token >= E * C
    clamped = torch.clamp(slot_by_token, max=E * C - 1)
    if e_axes:
        e_idx = clamped // C - shr.mesh_coord(e_axes)[0] * El
        c_idx = clamped % C
        mine = (e_idx >= 0) & (e_idx < El) & ~dropped
        w_eff = torch.where(mine, topw, 0.0).to(dt)
        e_idx = e_idx.clamp(0, El - 1)
    else:
        e_idx, c_idx = clamped // C, clamped % C             # (G, gs, k)
        w_eff = torch.where(dropped, 0.0, topw).to(dt)
    g_idx = torch.arange(G, device=out_buf.device)[:, None]
    yg = torch.zeros((G, gs, d), dtype=dt, device=out_buf.device)
    for j in range(k):
        gj = out_buf[g_idx, e_idx[:, :, j], c_idx[:, :, j]]  # (G, gs, d)
        yg = yg + w_eff[:, :, j][:, :, None] * gj
    return shr.all_reduce(yg, "sum", e_axes)


def _moe_sharded(params, cfg: ModelConfig, xg, logits, E, k, C):
    """The routed experts of ``moe_ffn`` on one rank's shards -> yg (G, gs,
    d): ``_plan``, ``_gather_slots`` and ``_combine`` as regions bounded by
    the reference's annotations (module docstring)."""
    G, gs, d = xg.shape
    grp = ("expert_group", None, None)
    slot_ax = ("expert_group", "expert", None)
    buf_ax = ("expert_group", "expert", None, None)

    topw, inv, slot_by_token = shr.local_region(
        lambda lg: _plan(lg, cfg, E, k, C), [logits], [grp],
        [(grp, (G, gs, k)), (grp, (G, E, C)), (grp, (G, gs, k))])
    inv = shard(inv, slot_ax)
    e_axes = shr.spec_axes(slot_ax, (G, E, C), 1)

    buf = shr.local_region(_gather_slots, [xg, inv], [grp, slot_ax],
                           (buf_ax, (G, E, C, d)))
    buf = shard(buf, buf_ax)
    out_buf = _experts(params, activation(cfg.act), buf, xg.dtype)
    out_buf = shard(out_buf, buf_ax)
    yg = shr.local_region(
        lambda ob, sbt, tw: _combine(ob, sbt, tw, E, C, e_axes),
        [out_buf, slot_by_token, topw], [buf_ax, grp, grp],
        (grp, (G, gs, d)))
    return shard(yg, grp)


def aux_load_balance_loss(logits: torch.Tensor, topi: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss: ``n_experts`` x the sum
    over experts of the mean router probability times the share of tokens
    whose first choice it is. logits (T, E), topi (T, k)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(dim=0)
    onehot = torch.nn.functional.one_hot(topi[:, 0].long(), n_experts)
    ce = onehot.to(torch.float32).mean(dim=0)
    return n_experts * torch.sum(me * ce)
