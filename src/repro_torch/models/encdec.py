"""Encoder-decoder assembly, the seamless-m4t backbone (port of
``repro.models.encdec``).

The speech frontend is a stub: the caller supplies precomputed frame
embeddings (B, S_src, frame_dim), which the ``frontend`` matrix lifts to
d_model. Encoder: bidirectional self-attention blocks (no mask, positions
from ``arange``). Decoder: causal self-attention, cross-attention over the
encoded memory (no RoPE, scale 1/sqrt(hd)) and MLP blocks. As in the
decoder-only models, each stack's parameters are stacked along a leading
``layers`` axis and run as a Python loop over per-layer views.

The cache is ``{"dec": {"k", "v", "xk", "xv"}}``, layer-stacked: the
self-attention K/V (L, B, max_len, Hkv, hd), written in place by each
decode step, and the cross-attention K/V of the memory (L, B, S_src, H,
hd), computed once by the prefill and never written again.

As in the reference (DESIGN.md §5): RoPE replaces seamless's learned or
relative positions, and the conformer convolution module of the speech
encoder is outside the backbone.

Sharded (inside an LM mesh) the reference's eight annotations — the
encoder's q heads, each block's residual at its edges, the frontend's and
the embedding's outputs — are ``shard`` calls at the same places.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ModelConfig, dense_spec, norm_spec,
                                       store_layer, tree_map)
from repro_torch.models.layers import (chunked_ce_loss, embed, embed_specs,
                                       mlp, mlp_specs, rmsnorm, unembed)
from repro_torch.sharding.rules import shard


# ------------------------------------------------------------------ blocks ----
def enc_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": norm_spec(cfg.d_model), "attn": attn.gqa_specs(cfg),
            "ln2": norm_spec(cfg.d_model), "mlp": mlp_specs(cfg)}


def enc_block_fwd(p, cfg: ModelConfig, x):
    """Bidirectional self-attention + MLP."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn._qkv(p["attn"], cfg, h, attn._positions(h.shape[1],
                                                          h.device))
    q = shard(q, ("batch", None, "heads", None))
    x = shard(x + attn._out_proj(attn.sdpa(q, k, v, None), p["attn"]["wo"]),
              ("batch", "act_seq", None))
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return shard(x + mlp(p["mlp"], cfg, h), ("batch", "act_seq", None))


def dec_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": norm_spec(cfg.d_model), "attn": attn.gqa_specs(cfg),
            "lnx": norm_spec(cfg.d_model), "xattn": attn.cross_specs(cfg),
            "ln2": norm_spec(cfg.d_model), "mlp": mlp_specs(cfg)}


def _cross_kv(p, memory):
    """The memory's cross-attention K and V, (B, S_src, H, hd) each."""
    return attn._proj(memory, p["wk"]), attn._proj(memory, p["wv"])


def _cross_apply(p, x, k, v, scale=None):
    dt = x.dtype
    q = attn._proj(x, p["wq"])
    out = attn.sdpa(q, k.to(dt), v.to(dt), None, scale)
    return attn._out_proj(out, p["wo"])


def dec_block_fwd(p, cfg: ModelConfig, x, memory):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = shard(x + attn.gqa_attention(p["attn"], cfg, h), ("batch", "act_seq", None))   # causal
    h = rmsnorm(x, p["lnx"], cfg.norm_eps)
    k, v = _cross_kv(p["xattn"], memory)
    x = shard(x + _cross_apply(p["xattn"], h, k, v), ("batch", "act_seq", None))
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return shard(x + mlp(p["mlp"], cfg, h), ("batch", "act_seq", None))


def dec_block_prefill(p, cfg: ModelConfig, x, memory, max_len: int):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, (sk, sv) = attn.gqa_prefill(p["attn"], cfg, h)
    cache = {"k": tfm._pad_len(sk, max_len), "v": tfm._pad_len(sv, max_len)}
    x = x + a
    h = rmsnorm(x, p["lnx"], cfg.norm_eps)
    cache["xk"], cache["xv"] = _cross_kv(p["xattn"], memory)
    x = x + _cross_apply(p["xattn"], h, cache["xk"], cache["xv"])
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h), cache


def dec_block_decode(p, cfg: ModelConfig, x, cache, pos):
    """One-token decode: the self-attention K/V written IN PLACE at ``pos``
    (a Python int or a (B,) tensor), the cross K/V read."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, _ = attn.gqa_decode(p["attn"], cfg, h, (cache["k"], cache["v"]), pos)
    x = x + a
    h = rmsnorm(x, p["lnx"], cfg.norm_eps)
    x = x + _cross_apply(p["xattn"], h, cache["xk"], cache["xv"])
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h), cache


# ------------------------------------------------------------------- model ----
def encdec_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": embed_specs(cfg),
        "frontend": dense_spec(cfg.vision_width, cfg.d_model, ("embed", None)),
        "enc": tfm._stack_specs(enc_block_specs(cfg), cfg.n_enc_layers),
        "enc_norm": norm_spec(cfg.d_model),
        "dec": tfm._stack_specs(dec_block_specs(cfg), cfg.n_layers),
        "final_norm": norm_spec(cfg.d_model),
    }


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_src, frame_dim) stub embeddings -> memory (B, S_src, d)."""
    (enc, _), params = tfm._layers(params, cfg), tfm.as_tree(params)
    x = frames.to(cfg.cdtype) @ params["frontend"].to(cfg.cdtype)
    x = shard(x, ("batch", "act_seq", None))
    fwd = tfm._maybe_remat(enc_block_fwd, cfg)
    for lp in enc:
        x = fwd(lp, cfg, x)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def encdec_hidden(params, cfg: ModelConfig, frames, tokens) -> torch.Tensor:
    """(frames, tokens (B, S)) -> the decoder's final-norm hidden states."""
    memory = encode(params, cfg, frames)
    (_, dec), params = tfm._layers(params, cfg), tfm.as_tree(params)
    x = shard(embed(params["embed"], tokens, cfg), ("batch", "act_seq", None))
    fwd = tfm._maybe_remat(dec_block_fwd, cfg)
    for lp in dec:
        x = fwd(lp, cfg, x, memory)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def encdec_loss(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: ``frames``, ``tokens``, ``labels`` [, ``mask``] -> the decoder's
    scalar float32 cross-entropy."""
    hidden = encdec_hidden(params, cfg, batch["frames"], batch["tokens"])
    return chunked_ce_loss(tfm.as_tree(params)["embed"], cfg, hidden,
                           batch["labels"], batch.get("mask"))


# ------------------------------------------------------------------- serve ----
def encdec_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                       src_len: int, dtype=None) -> dict:
    """{"dec": {leaf: (shape, dtype, logical axes)}}, layer-stacked."""
    dtype = dtype or cfg.cdtype
    H, hd, Hkv = cfg.n_heads, cfg.hd, cfg.n_kv_heads
    self_axes = ("batch", "kv_len", "kv_heads", None)
    cross_axes = ("batch", None, "heads", None)
    per_layer = {
        "k": ((batch, max_len, Hkv, hd), dtype, self_axes),
        "v": ((batch, max_len, Hkv, hd), dtype, self_axes),
        "xk": ((batch, src_len, H, hd), dtype, cross_axes),
        "xv": ((batch, src_len, H, hd), dtype, cross_axes),
    }
    return {"dec": tfm._stack_cache_specs(per_layer, cfg.n_layers)}


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      src_len: int, dtype=None, device=None) -> dict:
    device = torch.device("cuda") if device is None else torch.device(device)
    return tree_map(lambda t: torch.zeros(t[0], dtype=t[1], device=device),
                    encdec_cache_specs(cfg, batch, max_len, src_len, dtype))


def encdec_prefill(params, cfg: ModelConfig, frames, tokens, max_len: int):
    """Encode the frames, process the prompt; return (last-position logits
    (B, 1, V), cache). A prompt longer than ``max_len`` raises
    ``ValueError`` before any work (``check_fits``)."""
    tfm.check_fits(tokens.shape[1], max_len)
    memory = encode(params, cfg, frames)
    (_, dec), params = tfm._layers(params, cfg), tfm.as_tree(params)
    x = embed(params["embed"], tokens, cfg)
    buf = None
    for j, lp in enumerate(dec):
        x, c = dec_block_prefill(lp, cfg, x, memory, max_len)
        buf = store_layer(buf, j, len(dec), c)
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h[:, -1:, :], cfg), {"dec": buf}


def encdec_decode(params, cfg: ModelConfig, token, pos, cache: dict):
    """One decode step; the cache is written in place and returned with the
    logits (B, 1, V). Positions are checked once against the self-attention
    cache's length (``k``'s, not the memory's S_src)."""
    attn.check_positions(pos, cache["dec"]["k"].shape[2])
    (_, dec), params = tfm._layers(params, cfg), tfm.as_tree(params)
    x = embed(params["embed"], token, cfg)
    for layer, lp in enumerate(dec):
        lc = tree_map(lambda t, layer=layer: t[layer], cache["dec"])
        x, _ = dec_block_decode(lp, cfg, x, lc, pos)
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h, cfg), cache
