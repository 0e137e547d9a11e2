"""Attention, GQA half (port of ``repro.models.attention``): projections
with optional bias, masks, the einsum ``sdpa``, the flash dispatch, and the
KV-cache prefill/decode.

``run_attention`` sends prefill to ``kernels.ops.flash_attention`` (the
flash kernel on the card) when ``cfg.use_flash`` is set, as the JAX package
sends it to its Pallas kernel; decode always uses ``sdpa``, plain PyTorch
matmuls, as the JAX package computes it outside any kernel. ``sdpa`` rounds
where the reference does: q is scaled in q's dtype before the product,
scores are float32, probabilities are cast back to q's dtype before the
product with v.

MLA, cross and prefix-LM attention and the q-chunked ``sdpa_chunked`` are
not ported (ROADMAP.md item A12).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, Spec
from repro_torch.models.layers import apply_rope

NEG = -1e30


# ------------------------------------------------------------------- masks ----
def causal_mask(S: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((S, S), dtype=torch.bool, device=device))


# --------------------------------------------------------------- GQA attn ----
def gqa_specs(cfg: ModelConfig) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "wq": Spec((d, H, hd), ("embed", "heads", None), 1.0 / math.sqrt(d)),
        "wk": Spec((d, Hkv, hd), ("embed", "kv_heads", None), 1.0 / math.sqrt(d)),
        "wv": Spec((d, Hkv, hd), ("embed", "kv_heads", None), 1.0 / math.sqrt(d)),
        "wo": Spec((H, hd, d), ("heads", None, "embed"), 1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((H, hd), ("heads", None), 0.0)
        s["bk"] = Spec((Hkv, hd), ("kv_heads", None), 0.0)
        s["bv"] = Spec((Hkv, hd), ("kv_heads", None), 0.0)
    return s


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _qkv(params, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd), RoPE applied."""
    dt = x.dtype
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    B, S, H, k = out.shape
    return out.reshape(B, S, H * k) @ wo.to(out.dtype).reshape(H * k, -1)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None, scale: float | None = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,Hkv,hd) with GQA head-group broadcast;
    ``mask`` (Sq, Skv) or (B, Sq, Skv) bool, True = attend."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale or (1.0 / math.sqrt(hd))
    qg = (q.reshape(B, Sq, Hkv, G, hd) * scale).to(torch.float32)
    scores = torch.einsum("bqhgc,bkhc->bhgqk", qg, k.to(torch.float32))
    if mask is not None:
        m = mask[:, None, None] if mask.dim() == 3 else mask
        scores = torch.where(m, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def run_attention(cfg: ModelConfig, q, k, v, scale: float | None = None):
    """Dispatch: the flash kernel when ``cfg.use_flash``, else ``sdpa``
    under a causal mask. (The JAX package's prefix-LM and q-chunked
    branches are not ported: ROADMAP.md item A12.)"""
    if cfg.attn_chunk:
        raise NotImplementedError(
            "attn_chunk > 0: sdpa_chunked is not ported (ROADMAP.md item A12)")
    if cfg.use_flash:
        return ops.flash_attention(q, k, v, causal=True, scale=scale)
    return sdpa(q, k, v, causal_mask(q.shape[1], q.device), scale)


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def gqa_attention(params, cfg: ModelConfig, x: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  pos: torch.Tensor | None = None) -> torch.Tensor:
    B, S, _ = x.shape
    if pos is None:
        pos = _positions(S, x.device)
    q, k, v = _qkv(params, cfg, x, pos)
    out = run_attention(cfg, q, k, v) if mask is None else sdpa(q, k, v, mask)
    return _out_proj(out, params["wo"])


# ------------------------------------------------------------ GQA + cache ----
def gqa_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                mask: torch.Tensor | None = None):
    """Returns (attn_out, (k, v)) for the processed prefix."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, _positions(S, x.device))
    out = run_attention(cfg, q, k, v) if mask is None else sdpa(q, k, v, mask)
    return _out_proj(out, params["wo"]), (k, v)


def check_positions(pos, Smax: int) -> None:
    """Raise ``IndexError`` unless every decode position lies in [0, Smax).

    ``pos`` is a Python int (checked on the host) or a (B,) tensor (one
    host read). The JAX package's per-row ``dynamic_update_slice`` clamps a
    start that is out of range; the search never produces one, so here it
    is an error. A decode step checks once (``transformer.lm_decode``), not
    once per layer and cache leaf."""
    if isinstance(pos, int):
        if not 0 <= pos < Smax:
            raise IndexError(f"decode position {pos} outside [0, {Smax})")
    elif not bool(((pos >= 0) & (pos < Smax)).all()):
        raise IndexError(f"decode positions outside [0, {Smax})")


def update_cache_at(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B,1,...) into ``cache`` (B,Smax,...) at position
    ``pos`` — a Python int shared by every row, or a (B,) tensor of
    per-row positions — IN PLACE, and return ``cache``. The positions are
    range-checked once a decode step by ``lm_decode`` (``check_positions``).
    """
    if isinstance(pos, int):
        cache[:, pos] = new[:, 0].to(cache.dtype)
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.reshape(-1).long()] = new[:, 0].to(cache.dtype)
    return cache


def gqa_decode(params, cfg: ModelConfig, x: torch.Tensor, cache: tuple, pos):
    """One-token decode. x: (B,1,d); cache k/v: (B,Smax,Hkv,hd) written IN
    PLACE at ``pos`` (a Python int, or a (B,) tensor)."""
    k_cache, v_cache = cache
    B = x.shape[0]
    if isinstance(pos, int):
        pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    else:
        pos_b = pos.reshape(-1, 1).to(torch.int32).expand(B, 1)
    q, k_new, v_new = _qkv(params, cfg, x, pos_b)
    update_cache_at(k_cache, k_new, pos if isinstance(pos, int) else pos_b)
    update_cache_at(v_cache, v_new, pos if isinstance(pos, int) else pos_b)
    Smax = k_cache.shape[1]
    valid = torch.arange(Smax, device=x.device)[None, :] <= pos_b  # (B, Smax)
    out = sdpa(q, k_cache.to(x.dtype), v_cache.to(x.dtype),
               valid[:, None, :])                                  # (B,1,Smax)
    return _out_proj(out, params["wo"]), (k_cache, v_cache)
