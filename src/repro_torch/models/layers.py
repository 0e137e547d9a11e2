"""Shared neural building blocks: norm, RoPE, MLP, embeddings (port of the
parts of ``repro.models.layers`` the dense decoder needs).

Each function rounds where its JAX twin rounds: ``rmsnorm`` normalises in
float32 and casts before the weight multiply (the ``"model"`` order of the
norm kernel), ``apply_rope`` rotates in float32 and casts back, matmuls run
in the activations' dtype.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, Spec, activation, dense_spec


# -------------------------------------------------------------------- norm ----
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The model's norm: ``(x32 * rsqrt(mean(x32^2) + eps)).astype(dt) *
    w.astype(dt)``. On the card this is the rmsnorm kernel (its ``"model"``
    order); on the CPU its plain version."""
    return ops.rmsnorm(x, w, eps=eps, order="model")


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
    if "wg" in params:
        h = act(x @ params["wg"].to(dt)) * (x @ params["wu"].to(dt))
    else:
        h = act(x @ params["wu"].to(dt))
    return h @ params["wd"].to(dt)


# -------------------------------------------------------------- embeddings ----
def embed_specs(cfg: ModelConfig) -> dict:
    s = {"embedding": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed"), 0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = Spec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                            1.0 / (cfg.d_model ** 0.5))
    return s


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embedding"][tokens.long()].to(cfg.cdtype)


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embedding"].T.to(x.dtype)
    else:
        w = params["unembed"].to(x.dtype)
    return x @ w
