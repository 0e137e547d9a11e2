"""Mamba-2 (SSD) block: chunked state-space dual scan + causal conv + gating
(port of ``repro.models.ssm``).

The SSD algorithm (Dao & Gu, arXiv:2405.21060) in its chunked form, as the
JAX package writes it: the intra-chunk quadratic term, chunk states, and the
inter-chunk state passing as one strictly lower-triangular (nc x nc)
product instead of a sequential scan. Scalar-per-head decay A, d_state N in
one group, headdim P. Every cast is where the reference casts: the decays
are float32 until they meet the activations, which stay in their dtype.

Decode is the one-token recurrence with a carried (state, conv) cache; on
the port the step writes its new state into the cache it is given (in
place), where the JAX package returns a new cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, Spec, dense_spec, norm_spec
from repro_torch.models.layers import rmsnorm
from repro_torch.sharding.rules import shard


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_headdim
    return d_inner, H, cfg.ssm_headdim, cfg.ssm_state


def mamba2_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, H, P, N = ssm_dims(cfg)
    K = cfg.ssm_conv
    conv_dim = d_inner + 2 * N
    return {
        "w_z": dense_spec(d, d_inner, ("embed", "mlp")),
        "w_x": dense_spec(d, d_inner, ("embed", "mlp")),
        "w_B": dense_spec(d, N, ("embed", None)),
        "w_C": dense_spec(d, N, ("embed", None)),
        "w_dt": dense_spec(d, H, ("embed", "ssm_heads")),
        "dt_bias": Spec((H,), ("ssm_heads",), 0.0),
        "A_log": Spec((H,), ("ssm_heads",), scale=1.0),  # A = -exp(A_log)
        "D": Spec((H,), ("ssm_heads",), scale=1.0),
        "w_conv": Spec((K, conv_dim), ("conv", None), 1.0 / math.sqrt(K)),
        "b_conv": Spec((conv_dim,), (None,), 0.0),
        "norm": norm_spec(d_inner),
        "w_out": dense_spec(d_inner, d, ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,L,C), w: (K,C): out[t] = sum_k
    x[t-K+1+k] * w[k] + b. The K taps are summed in float32 and cast once
    (a convolution's accumulator), not through cuDNN, whose float32 path
    would run in TF32 on the card."""
    K, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    acc = pad[:, 0:L].to(torch.float32) * w[0].to(x.dtype).to(torch.float32)
    for k in range(1, K):
        acc = acc + pad[:, k:k + L].to(torch.float32) * w[k].to(x.dtype).to(torch.float32)
    return acc.to(x.dtype) + b.to(x.dtype)


def conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    """One step of the depthwise conv: einsum("bkc,kc->bc", window, w) on
    ``dt`` operands, summed in float32 (a dot's accumulator), + b in ``dt``."""
    prod = window.to(dt).to(torch.float32) * w.to(dt).to(torch.float32)
    return prod.sum(1).to(dt) + b.to(dt)


def _projections(params, cfg: ModelConfig, x: torch.Tensor):
    dt_ = x.dtype
    z = x @ params["w_z"].to(dt_)
    xs = x @ params["w_x"].to(dt_)
    Bm = x @ params["w_B"].to(dt_)
    Cm = x @ params["w_C"].to(dt_)
    dt = F.softplus((x @ params["w_dt"].to(dt_)).to(torch.float32)
                    + params["dt_bias"].to(torch.float32))
    return z, xs, Bm, Cm, dt


def _decay(diff: torch.Tensor, dtype) -> torch.Tensor:
    return torch.exp(torch.clamp(diff, -60.0, 0.0)).to(dtype)


def mamba2_forward(params, cfg: ModelConfig, x: torch.Tensor,
                   return_cache: bool = False):
    """Full-sequence SSD. x: (B, L, d) -> (B, L, d) [, decode cache]."""
    Bsz, L, d = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, L)      # short sequences: one chunk
    if L % Q:
        raise ValueError(f"mamba2_forward: length {L} is not a multiple of "
                         f"the chunk {Q}")
    nc = L // Q
    dt_ = x.dtype
    dev = x.device

    z, xs, Bm, Cm, dt = _projections(params, cfg, x)
    cat_pre = torch.cat([xs, Bm, Cm], dim=-1)
    cat = F.silu(_causal_conv(cat_pre, params["w_conv"], params["b_conv"]))
    xs, Bm, Cm = torch.split(cat, [d_inner, N, N], dim=-1)

    xs = shard(xs.reshape(Bsz, L, H, P), ("batch", None, "ssm_heads", None))
    A = -torch.exp(params["A_log"].to(torch.float32))      # (H,)
    log_a = dt * A                                         # (B,L,H) f32, <=0
    xbar = xs * dt.to(dt_)[..., None]                      # (B,L,H,P)

    log_a = log_a.reshape(Bsz, nc, Q, H)
    cs = torch.cumsum(log_a, dim=2)                        # inclusive
    xbar = xbar.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    # ---- intra-chunk (quadratic) ----
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    ddecay = torch.where(tri[None, None, :, :, None],
                         torch.exp(torch.clamp(cs[:, :, :, None, :]
                                               - cs[:, :, None, :, :],
                                               -60.0, 0.0)),
                         0.0).to(dt_)                      # (B,nc,Q,Q,H)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # (B,nc,Q,Q)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * ddecay, xbar)

    # ---- chunk states ----
    to_end = _decay(cs[:, :, -1:, :] - cs, dt_)            # (B,nc,Q,H)
    S_chunk = torch.einsum("bcjn,bcjhp->bchnp", Bc,
                           to_end[..., None] * xbar)       # (B,nc,H,N,P)

    # ---- inter-chunk state passing as a triangular product ----
    from_start = _decay(cs, dt_)                           # (B,nc,Q,H)
    G = torch.cumsum(cs[:, :, -1, :], dim=1)               # (B,nc,H) f32
    Gprev = F.pad(G[:, :-1], (0, 0, 1, 0))                 # G[c-1]; 0 at c=0
    diff = Gprev[:, :, None, :] - G[:, None, :, :]         # (B,nc,nc,H)
    ctri = torch.tril(torch.ones((nc, nc), dtype=torch.bool, device=dev), -1)
    T = torch.where(ctri[None, :, :, None],
                    torch.exp(torch.clamp(diff, -60.0, 0.0)), 0.0).to(dt_)
    S_prev = torch.einsum("bcCh,bChnp->bchnp", T, S_chunk)   # (B,nc,H,N,P)
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc, S_prev) \
        * from_start[..., None]                            # (B,nc,Q,H,P)
    w_final = _decay(G[:, -1:, :] - G, dt_)                # (B,nc,H)
    S_final = torch.einsum("bch,bchnp->bhnp", w_final, S_chunk)

    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    y = y + params["D"].to(dt_)[None, None, :, None] * xs
    y = y.reshape(Bsz, L, d_inner)
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["w_out"].to(dt_)
    if return_cache:
        cache = {"state": S_final,
                 "conv": cat_pre[:, L - (cfg.ssm_conv - 1):, :]}
        return out, cache
    return out


# ------------------------------------------------------------------ decode ----
def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt, _) in mamba2_cache_specs(cfg, batch, dtype).items()}


def mamba2_cache_specs(cfg: ModelConfig, batch: int, dtype) -> dict:
    d_inner, H, P, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N
    return {
        "state": ((batch, H, N, P), dtype, ("batch", "ssm_heads", None, None)),
        "conv": ((batch, cfg.ssm_conv - 1, conv_dim), dtype,
                 ("batch", None, None)),
    }


def mamba2_decode(params, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """Single-token step. x: (B,1,d) -> (B,1,d); the cache's state and conv
    window are written IN PLACE and the cache returned."""
    Bsz = x.shape[0]
    d_inner, H, P, N = ssm_dims(cfg)
    dt_ = x.dtype
    z, xs, Bm, Cm, dt = _projections(params, cfg, x)
    cat = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]             # (B, conv_dim)
    window = torch.cat([cache["conv"], cat[:, None, :].to(cache["conv"].dtype)],
                       dim=1)                               # (B,K,Cd)
    cat = F.silu(conv_step(window, params["w_conv"], params["b_conv"], dt_))
    xs, Bm, Cm = torch.split(cat, [d_inner, N, N], dim=-1)
    xs = xs.reshape(Bsz, H, P)
    A = -torch.exp(params["A_log"].to(torch.float32))
    a = torch.exp(dt[:, 0] * A).to(dt_)                     # (B,H)
    xbar = xs * dt[:, 0].to(dt_)[..., None]                 # (B,H,P)
    S = cache["state"].to(dt_)
    S = a[:, :, None, None] * S + Bm[:, None, :, None] * xbar[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", Cm, S)
    y = y + params["D"].to(dt_)[None, :, None] * xs
    y = y.reshape(Bsz, 1, d_inner)
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["w_out"].to(dt_)
    cache["state"].copy_(S)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
