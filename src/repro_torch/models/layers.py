"""Shared neural building blocks: norms, RoPE, sinusoidal positions, MLP,
embeddings, the token cross-entropy and its sequence-chunked form (port of
``repro.models.layers``).

Sharded (DTensor activations inside an LM mesh) the reference's three
annotations — the MLP's hidden (``mlp``), the embedded tokens, the logits
(``vocab``) — are ``shard`` calls, and the embedding lookup from a table
split over ``vocab`` is a region on each rank's rows of the table: the
tokens it holds are looked up, the rest give zeros, and the sum over the
split is the embedding (``_embed_sharded``).

Each function rounds where its JAX twin rounds: ``rmsnorm`` normalises in
float32 and casts before the weight multiply (the ``"model"`` order of the
norm kernel), ``apply_rope`` rotates in float32 and casts back, matmuls run
in the activations' dtype.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as _ckpt

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, Spec, activation, dense_spec
from repro_torch.sharding import rules as shr
from repro_torch.sharding.rules import shard


# -------------------------------------------------------------------- norm ----
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The model's norm: ``(x32 * rsqrt(mean(x32^2) + eps)).astype(dt) *
    w.astype(dt)``. On the card this is the rmsnorm kernel (its ``"model"``
    order), which takes a contiguous x; on the CPU its plain version. A
    DTensor's normed axis is gathered whole first (the kernel norms whole
    rows)."""
    x = shr.whole_dims(x, (x.dim() - 1,))
    return ops.rmsnorm(x.contiguous(), w, eps=eps, order="model")


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm with float32 statistics (biased variance), cast to x's
    dtype before the affine, as the reference rounds. No served path of
    either package calls it."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * w.to(dt) + b.to(dt)


# -------------------------------------------------------------------- rope ----
@functools.lru_cache(maxsize=16)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """(hd/2,) float32 inverse frequencies. A constant of (hd, theta), made
    once per device: each decode step would otherwise relaunch it per layer.
    Callers must not write into it."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return _rope_freqs(hd, float(theta), device)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) rotated pairwise (halves); pos: (..., S) int
    positions. float32 math, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = pos[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                 # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(..., S) positions -> (..., S, d) float32 sinusoidal embeddings,
    sines then cosines. No served path of either package calls it."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=pos.device) / half)
    ang = pos[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------- mlp ----
def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    ff = d_ff or cfg.d_ff
    d = cfg.d_model
    if cfg.act in ("silu", "gelu"):  # gated (SwiGLU/GeGLU)
        return {"wg": dense_spec(d, ff, ("embed", "mlp")),
                "wu": dense_spec(d, ff, ("embed", "mlp")),
                "wd": dense_spec(ff, d, ("mlp", "embed"))}
    return {"wu": dense_spec(d, ff, ("embed", "mlp")),
            "wd": dense_spec(ff, d, ("mlp", "embed"))}


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    dt = x.dtype
    mm = shr.fold_matmul
    if "wg" in params:
        h = act(mm(x, params["wg"].to(dt))) * mm(x, params["wu"].to(dt))
    else:
        h = act(mm(x, params["wu"].to(dt)))
    h = shard(h, ("batch", None, "mlp"))
    return mm(h, params["wd"].to(dt))


# -------------------------------------------------------------- embeddings ----
def embed_specs(cfg: ModelConfig) -> dict:
    s = {"embedding": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed"), 0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = Spec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                            1.0 / (cfg.d_model ** 0.5))
    return s


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embedding"]
    if isinstance(w, DTensor):
        x = _embed_sharded(w, tokens)
    else:
        x = _lookup(w, tokens)
    return shard(x.to(cfg.cdtype), ("batch", None, None))


def _lookup(w, tokens, v_axes: tuple[str, ...] = ()):
    """``embed``'s lookup. With the table's rows split over the LM mesh's
    ``v_axes`` (inside a region), ``w`` is this rank's rows: a token
    outside them gives zeros, and the sum over the split is the
    embedding."""
    tok = tokens.long()
    if not v_axes:
        return w[tok]
    lt = tok - shr.mesh_coord(v_axes)[0] * w.shape[0]
    ok = (lt >= 0) & (lt < w.shape[0])
    x = w[lt.clamp(0, w.shape[0] - 1)] * ok[..., None].to(w.dtype)
    return shr.all_reduce(x, "sum", v_axes)


def _embed_sharded(w, tokens):
    """The lookup on one rank (``_lookup``): its rows of the table
    (``vocab`` split, the ``embed`` axis gathered), its tokens."""
    V, d = w.shape
    v_axes = shr.spec_axes(("vocab", None), (V, d), 0)
    t_ax = ("batch",) + (None,) * (tokens.dim() - 1)
    return shr.local_region(lambda w, t: _lookup(w, t, v_axes), [w, tokens],
                            [("vocab", None), t_ax],
                            (t_ax + (None,), (*tokens.shape, d)))


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embedding"].T.to(x.dtype)
    else:
        w = params["unembed"].to(x.dtype)
    return shard(shr.fold_matmul(x, w), ("batch", None, "vocab"))


# -------------------------------------------------------------------- loss ----
def _nll(logits: torch.Tensor, targets: torch.Tensor,
         v_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """Per-token negative log-likelihood in float32: logsumexp minus the
    target's logit. On DTensors, each rank's share (``_nll_sharded``).
    With the vocab split over the LM mesh's ``v_axes`` (inside a region),
    ``logits`` are this rank's slice: the logsumexp's max and sum are
    all-reduced over the split, and the target's logit is looked up by the
    rank that holds it (zeros elsewhere) and summed over the split."""
    if isinstance(logits, DTensor):
        return _nll_sharded(logits, targets)
    logits = logits.to(torch.float32)
    if v_axes:
        Vl = logits.shape[-1]
        mx = shr.all_reduce(logits.detach().amax(dim=-1, keepdim=True),
                            "max", v_axes)
        se = torch.exp(logits - mx).sum(dim=-1)
        tg = targets.long() - shr.mesh_coord(v_axes)[0] * Vl
        ok = (tg >= 0) & (tg < Vl)
        tg = tg.clamp(0, Vl - 1)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        tg = targets.long()
    ll = torch.gather(logits, -1, tg[..., None])[..., 0]
    if v_axes:
        ll = ll * ok.to(ll.dtype)
        se = shr.all_reduce(se, "sum", v_axes)
        ll = shr.all_reduce(ll, "sum", v_axes)
        lse = torch.log(se) + mx[..., 0]
    return lse - ll


def _nll_sharded(logits, targets):
    """``_nll`` on one rank: its rows and its slice of the ``vocab``
    axis."""
    B, S, V = logits.shape
    v_axes = shr.spec_axes(("batch", None, "vocab"), (B, S, V), 2)
    return shr.local_region(
        lambda lg, tg: _nll(lg, tg, v_axes), [logits, targets],
        [("batch", None, "vocab"), ("batch", None)], (("batch", None), (B, S)))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross-entropy in float32; logits (B, S, V), targets (B,
    S); with a mask, the masked mean over ``max(mask.sum(), 1)``."""
    nll = _nll(logits, targets)
    if mask is None:
        return nll.mean()
    m = mask.to(torch.float32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def chunked_ce_loss(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    targets: torch.Tensor,
                    mask: torch.Tensor | None) -> torch.Tensor:
    """Cross-entropy with the unembedding applied one sequence chunk of
    ``cfg.logits_chunk`` positions at a time, in order, so that only a
    chunk's logits are live; unchunked when ``logits_chunk <= 0``, when it
    does not divide S or when it is S. Each chunk's logits are recomputed
    in the backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``); the sums run in the reference's order."""
    B, S, D = x.shape
    ck = cfg.logits_chunk
    if ck <= 0 or S % ck != 0 or S == ck:
        return cross_entropy(unembed(params, x, cfg), targets, mask)

    def chunk(xc, tc, mc):
        nll = _nll(unembed(params, xc, cfg), tc)
        m = mc.to(torch.float32)
        return (nll * m).sum(), m.sum()

    x = shr.fold_rows(x)     # each chunk a slice of the whole sequence
    ones = torch.ones((B, S), dtype=torch.float32, device=x.device)
    m_all = ones if mask is None else mask
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // ck):
        sl = slice(i * ck, (i + 1) * ck)
        n_c, m_c = _ckpt.checkpoint(shr.under_current_rules(chunk),
                                    x[:, sl], targets[:, sl],
                                    m_all[:, sl], use_reentrant=False)
        nll_sum, m_sum = nll_sum + n_c, m_sum + m_c
    return nll_sum / torch.clamp(m_sum, min=1.0)
