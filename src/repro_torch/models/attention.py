"""Attention (port of ``repro.models.attention``): GQA projections with
optional bias, the causal and prefix-LM masks, the einsum ``sdpa`` and its
q-chunked twin ``sdpa_chunked``, the dispatch ``run_attention``, the
prefix-LM attention of the vlm family, the KV-cache prefill/decode,
DeepSeek-V2's multi-head latent attention (MLA), whose cache holds the
latent ``(c_kv, k_pe)``, and the encoder-decoder's cross-attention.

``run_attention`` follows the reference's order: the flash kernel
(``kernels.ops.flash_attention``, the hand-written kernel on the card) when
``cfg.use_flash`` is set and there is no prefix, as the JAX package sends it
to its Pallas kernel; else ``sdpa_chunked`` when ``cfg.attn_chunk`` divides
the sequence into more than one chunk; else ``sdpa`` under the causal or
prefix-LM mask. Decode, the encoder and cross-attention always use
``sdpa``, plain PyTorch matmuls, as the JAX package computes them outside
any kernel. ``sdpa`` rounds where the reference does: q is scaled in q's
dtype before the product, scores are float32, probabilities are cast back
to q's dtype before the product with v.

MLA's v head dim differs from its q/k head dim, which the flash kernel does
not take: with ``use_flash`` it raises (``kernels.ops.flash_attention``), as
the reference's Pallas wrapper fails on it.

Sharded (inside an LM mesh, DTensor activations) the reference's
annotations are ``shard`` calls at the same places, and two bodies run on
each rank's local shards (``sharding.rules.local_region``): ``sdpa``'s (by
heads — a rank's q heads against their kv heads, found from the rank's head
offset when the kv heads do not divide the model axis and stay whole — or,
over a cache whose length is split, by kv slices with the softmax's max and
sum and the output all-reduced over the split) and the cache write's (each
rank writes the rows whose position falls in its slice). Each is the one
body the single-card path runs, given the split axes. The flash kernel does
not run sharded, as the reference's dry-run never runs it (``use_flash``
off).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, Spec, dense_spec, norm_spec
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.sharding import rules as shr
from repro_torch.sharding.rules import shard

NEG = -1e30


# ------------------------------------------------------------------- masks ----
def causal_mask(S: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((S, S), dtype=torch.bool, device=device))


def prefix_lm_mask(S: int, prefix_len: int, device=None) -> torch.Tensor:
    """Bidirectional over the first ``prefix_len`` positions, causal after
    (PaliGemma's image+prompt prefix)."""
    pre = torch.arange(S, device=device) < prefix_len
    return causal_mask(S, device) | (pre[None, :] & pre[:, None])


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
    """einsum("bsd,dhk->bshk") as one matmul (on DTensors, with the
    product's h*k axis split only as far as the h heads divide)."""
    d, h, k = w.shape
    w2 = w.to(x.dtype).reshape(d, h * k)
    if isinstance(w2, DTensor):
        w2 = shr.splittable_grad(w2, h)
    y = shr.fold_matmul(x, w2)
    if isinstance(y, DTensor):
        y = shr.heads_splittable(y, h)
    return y.reshape(*x.shape[:-1], h, k)


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
    flat = out.reshape(B, S, H * k)
    if isinstance(flat, DTensor):
        flat = shr.splittable_grad(flat, H)
    return shr.fold_matmul(flat, wo.to(out.dtype).reshape(H * k, -1))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None, scale: float | None = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,Hkv,hd) with GQA head-group broadcast;
    ``mask`` (Sq, Skv) or (B, Sq, Skv) bool, True = attend. On DTensors,
    each rank's share (``_sdpa_sharded``)."""
    if isinstance(q, DTensor):
        return _sdpa_sharded(q, k, v, mask, scale)
    return _sdpa_local(q, k, v, mask, scale)


def _sdpa_local(q, k, v, mask, scale, kv_axes: tuple[str, ...] = ()):
    """``sdpa``'s body. With the kv length split over the LM mesh's
    ``kv_axes`` (inside a region, ``_sdpa_sharded``), k, v and the mask
    are this rank's slice: the softmax's max (held constant: the softmax
    does not depend on it) and sum and the output are all-reduced over the
    split."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale or (1.0 / math.sqrt(hd))
    qg = (q.reshape(B, Sq, Hkv, G, hd) * scale).to(torch.float32)
    scores = torch.einsum("bqhgc,bkhc->bhgqk", qg, k.to(torch.float32))
    if mask is not None:
        m = mask[:, None, None] if mask.dim() == 3 else mask
        scores = torch.where(m, scores, NEG)
    if kv_axes:
        mx = shr.all_reduce(scores.detach().amax(dim=-1, keepdim=True),
                            "max", kv_axes)
        e = torch.exp(scores - mx)
        den = shr.all_reduce(e.sum(dim=-1, keepdim=True), "sum", kv_axes,
                             grad="sum")
        probs = (e / den).to(q.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    out = shr.all_reduce(out, "sum", kv_axes)
    return out.reshape(B, Sq, H, v.shape[-1])


def _sdpa_sharded(q, k, v, mask, scale):
    """``sdpa`` on one rank's shards. Over a cache whose length is split
    (decode: ``kv_len`` on the mesh) every rank scores all q heads against
    its kv slice (``_sdpa_local`` over ``kv_axes``). Otherwise by heads:
    the rank's q heads against their kv heads — when the kv heads stay
    whole (they do not divide the model axis), the ones the rank's q heads
    map to from its head offset."""
    B, Sq, H, _ = q.shape
    Hkv, dv = k.shape[2], v.shape[-1]
    m_ax = None
    kv_axes = shr.sharded_axes(k, 1)
    if kv_axes:
        if mask is not None:
            m_ax = ("batch", None, "kv_len") if mask.dim() == 3 else (
                None, "kv_len")
        kv = ("batch", "kv_len", None, None)
        return shr.local_region(
            lambda q, k, v, mask: _sdpa_local(q, k, v, mask, scale, kv_axes),
            [q, k, v, mask], [("batch", None, None, None), kv, kv, m_ax],
            (("batch", None, None, None), (B, Sq, H, dv)))

    q_ax = ("batch", None, "heads", None)
    kv_ax = ("batch", None, "kv_heads", None)
    head_axes = shr.spec_axes(q_ax, q.shape, 2)
    if mask is not None:
        m_ax = ("batch", None, None) if mask.dim() == 3 else (None, None)

    def local(q, k, v, mask):
        Hl, G = q.shape[2], H // Hkv
        if k.shape[2] * G != Hl:
            # the kv heads stay whole (they do not divide the axis that
            # splits the q heads): each local q head takes its own kv head,
            # found from the rank's head offset
            h0 = shr.mesh_coord(head_axes)[0] * Hl
            idx = torch.div(h0 + torch.arange(Hl, device=q.device), G,
                            rounding_mode="floor")
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        return _sdpa_local(q, k, v, mask, scale)

    return shr.local_region(local, [q, k, v, mask], [q_ax, kv_ax, kv_ax, m_ax],
                            (q_ax, (B, Sq, H, dv)))


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 chunk: int, prefix_len: int = 0,
                 scale: float | None = None) -> torch.Tensor:
    """Causal / prefix-LM attention, one query chunk at a time: the live
    score tensor is (B, H, chunk, S), and each chunk's mask is built from
    positions (never an (S, S) mask). Each chunk is ``sdpa`` on its rows,
    as the reference's scan computes it."""
    B, S, H, _ = q.shape
    if S % chunk:
        raise ValueError(f"sdpa_chunked: S = {S} is not a multiple of "
                         f"chunk = {chunk}")
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)
    outs = []
    for i in range(S // chunk):
        qpos = i * chunk + torch.arange(chunk, dtype=torch.int32,
                                        device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        mask = mask | ((qpos[:, None] < prefix_len)
                       & (kpos[None, :] < prefix_len))
        outs.append(sdpa(q[:, i * chunk:(i + 1) * chunk], k, v, mask, scale))
    return torch.cat(outs, dim=1)


def run_attention(cfg: ModelConfig, q, k, v, prefix_len: int = 0,
                  scale: float | None = None):
    """Dispatch, in the reference's order: the flash kernel when
    ``cfg.use_flash`` and there is no prefix; else ``sdpa_chunked`` when
    ``cfg.attn_chunk`` splits S into more than one chunk; else ``sdpa``
    under the causal (no prefix) or prefix-LM mask."""
    S = q.shape[1]
    if cfg.use_flash and prefix_len == 0:
        return ops.flash_attention(q, k, v, causal=True, scale=scale)
    if cfg.attn_chunk and S % cfg.attn_chunk == 0 and S > cfg.attn_chunk:
        return sdpa_chunked(q, k, v, cfg.attn_chunk, prefix_len, scale)
    mask = (causal_mask(S, q.device) if prefix_len == 0
            else prefix_lm_mask(S, prefix_len, q.device))
    return sdpa(q, k, v, mask, scale)


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def gqa_attention(params, cfg: ModelConfig, x: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  pos: torch.Tensor | None = None) -> torch.Tensor:
    B, S, _ = x.shape
    if pos is None:
        pos = _positions(S, x.device)
    q, k, v = _qkv(params, cfg, x, pos)
    q = shard(q, ("batch", None, "heads", None))
    k = shard(k, ("batch", None, "kv_heads", None))
    out = run_attention(cfg, q, k, v) if mask is None else sdpa(q, k, v, mask)
    out = shard(out, ("batch", None, "heads", None))
    return _out_proj(out, params["wo"])


def gqa_prefix_attention(params, cfg: ModelConfig, x: torch.Tensor,
                         prefix_len: int) -> torch.Tensor:
    """Prefix-LM attention (PaliGemma): bidirectional over the first
    ``prefix_len`` positions, causal after."""
    q, k, v = _qkv(params, cfg, x, _positions(x.shape[1], x.device))
    q = shard(q, ("batch", None, "heads", None))
    out = run_attention(cfg, q, k, v, prefix_len=prefix_len)
    out = shard(out, ("batch", None, "heads", None))
    return _out_proj(out, params["wo"])


# ------------------------------------------------------------ GQA + cache ----
def gqa_prefill(params, cfg: ModelConfig, x: torch.Tensor,
                mask: torch.Tensor | None = None, prefix_len: int = 0):
    """Returns (attn_out, (k, v)) for the processed prefix; ``prefix_len``
    rides through ``run_attention`` (the q-chunked path builds the
    prefix-LM mask per chunk)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, _positions(S, x.device))
    out = (run_attention(cfg, q, k, v, prefix_len=prefix_len)
           if mask is None else sdpa(q, k, v, mask))
    return _out_proj(out, params["wo"]), (k, v)


def check_positions(pos, Smax: int) -> None:
    """Raise ``IndexError`` unless every decode position lies in [0, Smax).

    ``pos`` is a Python int (checked on the host) or a (B,) tensor (one
    host read; a DTensor's local rows). The JAX package's per-row ``dynamic_update_slice`` clamps a
    start that is out of range; the search never produces one, so here it
    is an error. A decode step checks once (``transformer.lm_decode``), not
    once per layer and cache leaf. A ``meta`` tensor (the dry-run's,
    ``launch.dryrun``) has no values to check."""
    if isinstance(pos, DTensor):
        pos = pos.to_local()
    if isinstance(pos, int):
        if not 0 <= pos < Smax:
            raise IndexError(f"decode position {pos} outside [0, {Smax})")
    elif pos.is_meta:
        return
    elif not bool(((pos >= 0) & (pos < Smax)).all()):
        raise IndexError(f"decode positions outside [0, {Smax})")


def update_cache_at(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B,1,...) into ``cache`` (B,Smax,...) at position
    ``pos`` — a Python int shared by every row, or a (B,) tensor of
    per-row positions — IN PLACE, and return ``cache``. The positions are
    range-checked once a decode step by ``lm_decode`` (``check_positions``).
    On DTensors each rank writes the rows whose position falls in its
    slice of the cache's length (``_update_cache_sharded``).
    """
    if isinstance(cache, DTensor):
        return _update_cache_sharded(cache, new, pos)
    return _write_at(cache, new, pos)


def _write_at(cache, new, pos, kv_axes: tuple[str, ...] = ()):
    """``update_cache_at``'s body. With the cache's length split over the
    LM mesh's ``kv_axes`` (inside a region), ``cache`` is this rank's
    slice: a row whose position lies outside it rewrites its own current
    value, so every rank runs the same ops."""
    if isinstance(pos, int):
        cache[:, pos] = new[:, 0].to(cache.dtype)
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    val = new[:, 0].to(cache.dtype)
    p = pos.reshape(-1).long()
    if kv_axes:
        S = cache.shape[1]
        p = p - shr.mesh_coord(kv_axes)[0] * S
        ok = ((p >= 0) & (p < S)).reshape(-1, *([1] * (new.dim() - 2)))
        p = p.clamp(0, S - 1)
        val = torch.where(ok, val, cache[rows, p])
    cache[rows, p] = val
    return cache


def _update_cache_sharded(cache, new, pos):
    """``update_cache_at`` on one rank's shard (``_write_at`` over the
    cache's split of Smax); the cache keeps its placements. The positions
    are the inputs' own, never a collective's."""
    kv_axes = shr.sharded_axes(cache, 1)
    if isinstance(pos, int):
        pos = torch.full((cache.shape[0],), pos, dtype=torch.int32,
                         device=cache.to_local().device)
    new_pl = tuple(Replicate() if p.is_shard(1) else p
                   for p in cache.placements)
    return shr.local_region(
        lambda c, n, p: _write_at(c, n, p, kv_axes), [cache, new,
                                                      pos.reshape(-1)],
        [cache.placements, new_pl, ("batch",)],
        (cache.placements, tuple(cache.shape)))


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
    k_cache = shard(k_cache, ("batch", "kv_len", "kv_heads", None))
    v_cache = shard(v_cache, ("batch", "kv_len", "kv_heads", None))
    Smax = k_cache.shape[1]
    valid = torch.arange(Smax, device=x.device)[None, :] <= pos_b  # (B, Smax)
    out = sdpa(q, k_cache.to(x.dtype), v_cache.to(x.dtype),
               valid[:, None, :])                                  # (B,1,Smax)
    return _out_proj(out, params["wo"]), (k_cache, v_cache)


# ----------------------------------------------------------- MLA (DSv2) ----
def mla_specs(cfg: ModelConfig) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense_spec(d, qr, ("embed", "lora")),
        "q_norm": norm_spec(qr),
        "wq_b": Spec((qr, H, dn + dr), ("lora", "heads", None), 1.0 / math.sqrt(qr)),
        "wkv_a": dense_spec(d, kvr, ("embed", "lora")),
        "kv_norm": norm_spec(kvr),
        "wk_rope": dense_spec(d, dr, ("embed", None)),
        "wkv_b": Spec((kvr, H, dn + dv), ("lora", "heads", None),
                      1.0 / math.sqrt(kvr)),
        "wo": Spec((H, dv, d), ("heads", None, "embed"), 1.0 / math.sqrt(H * dv)),
    }


def _mla_qkv(params, cfg: ModelConfig, x, pos, c_kv, k_pe):
    """Shared MLA math given latent c_kv (B,S,kvr) and rope key k_pe
    (B,S,dr): q (B,Sq,H,dn+dr), k (B,S,H,dn+dr), v (B,S,H,dv), scale."""
    dt = x.dtype
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rmsnorm(shr.fold_matmul(x, params["wq_a"].to(dt)), params["q_norm"],
                 cfg.norm_eps)
    q = _proj(cq, params["wq_b"])
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    kv = _proj(c_kv, params["wkv_b"])
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k_pe_h = k_pe[:, :, None, :].expand(*k_pe.shape[:2], H, dr)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe_h], dim=-1)
    scale = 1.0 / math.sqrt(dn + dr)
    return q_full, k_full, v, scale


def _mla_latent(params, cfg: ModelConfig, x, pos):
    """The cached latent of x: c_kv (B,S,kvr) normed, k_pe (B,S,dr) rotated."""
    dt = x.dtype
    c_kv = rmsnorm(shr.fold_matmul(x, params["wkv_a"].to(dt)),
                   params["kv_norm"], cfg.norm_eps)
    k_pe = shr.fold_matmul(x, params["wk_rope"].to(dt))
    k_pe = apply_rope(k_pe[:, :, None, :], pos, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def mla_attention(params, cfg: ModelConfig, x: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    pos = _positions(x.shape[1], x.device)
    c_kv, k_pe = _mla_latent(params, cfg, x, pos)
    q, k, v, scale = _mla_qkv(params, cfg, x, pos, c_kv, k_pe)
    if mask is None:
        out = run_attention(cfg, q, k, v, scale=scale)
    else:
        out = sdpa(q, k, v, mask, scale)
    return _out_proj(out, params["wo"])


def mla_prefill(params, cfg: ModelConfig, x: torch.Tensor):
    """Returns (attn_out, (c_kv, k_pe)): the cache is the LATENT, per token
    kv_lora_rank + rope_dim values instead of 2·H·hd."""
    pos = _positions(x.shape[1], x.device)
    c_kv, k_pe = _mla_latent(params, cfg, x, pos)
    q, k, v, scale = _mla_qkv(params, cfg, x, pos, c_kv, k_pe)
    out = run_attention(cfg, q, k, v, scale=scale)
    return _out_proj(out, params["wo"]), (c_kv, k_pe)


def mla_decode(params, cfg: ModelConfig, x: torch.Tensor, cache: tuple, pos):
    """One-token decode. x: (B,1,d); cache c_kv (B,Smax,kvr), k_pe
    (B,Smax,dr), written IN PLACE at ``pos`` (a Python int or a (B,)
    tensor); every cached latent is expanded to per-head K/V each step, as
    in the reference."""
    c_cache, pe_cache = cache
    B = x.shape[0]
    dt = x.dtype
    if isinstance(pos, int):
        pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    else:
        pos_b = pos.reshape(-1, 1).to(torch.int32).expand(B, 1)
    c_new, pe_new = _mla_latent(params, cfg, x, pos_b)
    wpos = pos if isinstance(pos, int) else pos_b
    update_cache_at(c_cache, c_new, wpos)
    update_cache_at(pe_cache, pe_new, wpos)
    c_cache = shard(c_cache, ("batch", "kv_len", None))
    q, k, v, scale = _mla_qkv(params, cfg, x, pos_b, c_cache.to(dt),
                              pe_cache.to(dt))
    Smax = c_cache.shape[1]
    valid = torch.arange(Smax, device=x.device)[None, :] <= pos_b
    out = sdpa(q, k, v, valid[:, None, :], scale)
    return _out_proj(out, params["wo"]), (c_cache, pe_cache)


# ------------------------------------------------------------- cross attn ----
def cross_specs(cfg: ModelConfig) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "wq": Spec((d, H, hd), ("embed", "heads", None), 1.0 / math.sqrt(d)),
        "wk": Spec((d, H, hd), ("embed", "heads", None), 1.0 / math.sqrt(d)),
        "wv": Spec((d, H, hd), ("embed", "heads", None), 1.0 / math.sqrt(d)),
        "wo": Spec((H, hd, d), ("heads", None, "embed"), 1.0 / math.sqrt(H * hd)),
    }


def cross_attention(params, cfg: ModelConfig, x: torch.Tensor,
                    memory: torch.Tensor,
                    mem_mask: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, Sq, d) queries over encoder memory (B, Skv, d); no RoPE, scale
    1/sqrt(hd); ``mem_mask`` (B, Skv) bool, True = attend."""
    q = _proj(x, params["wq"])
    k = _proj(memory, params["wk"])
    v = _proj(memory, params["wv"])
    mask = None
    if mem_mask is not None:
        mask = mem_mask[:, None, :].expand(x.shape[0], x.shape[1],
                                           memory.shape[1])
    return _out_proj(sdpa(q, k, v, mask), params["wo"])
