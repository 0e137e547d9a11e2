"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule
(port of ``repro.optim.adamw``).

Over the port's parameter trees: nested dicts of tensors, or a
``TransformerLM`` (its ``tree()``). The moments are dicts of the same
shape, the step an int32 0-d tensor. The schedule and the bias corrections
are float32 arithmetic, as the reference's are (a Python float times a
float32 array rounds the float first); in Python doubles they would part
from the reference by an ulp. The schedule's cosine is the C library's
``cosf``, as on the reference's CPU backend (``lr_at``).

``adamw_update`` writes the parameters and the moments in place, under
``torch.no_grad()``, and returns them with the new step and the metrics (0-d
tensors: nothing is read on the host). A non-finite gradient norm leaves
parameters and moments as they were, and the step still advances.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.models.common import torch_dtype, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moment storage dtype; the update math stays float32
    moment_dtype: str = "float32"


def _tree(params) -> dict:
    return params.tree() if hasattr(params, "tree") else params


def _cosf():
    """The C library's single-precision cosine, the one XLA's CPU backend
    calls for a float32 ``jnp.cos`` (held equal on 20,000 arguments); where
    it cannot be loaded, the correctly rounded one."""
    name = ctypes.util.find_library("m")
    try:
        f = ctypes.CDLL(name).cosf
    except (OSError, AttributeError, TypeError):
        return lambda x: np.float32(math.cos(float(x)))
    f.restype, f.argtypes = ctypes.c_float, [ctypes.c_float]
    return lambda x: np.float32(f(float(x)))


@functools.lru_cache(maxsize=8)
def _decay_table(cfg: OptConfig) -> np.ndarray:
    """The cosine branch of the schedule at steps warmup .. total, float32,
    each operation rounded as the reference's float32 arithmetic rounds it
    (Python floats rounded to float32 first)."""
    f32 = np.float32
    cosf = _cosf()
    steps = np.arange(cfg.warmup_steps, max(cfg.warmup_steps,
                                            cfg.total_steps) + 1,
                      dtype=np.float32)
    t = (steps - f32(cfg.warmup_steps)) / f32(
        max(1, cfg.total_steps - cfg.warmup_steps))
    t = np.clip(t, f32(0.0), f32(1.0))
    c = np.array([cosf(x) for x in f32(math.pi) * t], dtype=np.float32)
    return f32(cfg.lr) * (f32(cfg.min_lr_frac)
                          + f32((1 - cfg.min_lr_frac) * 0.5) * (f32(1) + c))


@functools.lru_cache(maxsize=8)
def _decay_table_on(cfg: OptConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_decay_table(cfg)).to(device)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr``, float32, on
    ``step``'s device. The warmup is computed there; the cosine branch is
    read from a host-made table of every step from warmup to the end (past
    the end it stays at its last value), so that the card and the CPU give
    the reference's bits: no two libraries' float32 cosines agree in every
    last bit. The table's entry is read on the device (``index_select``):
    indexing with a 0-d tensor would read the step on the host, a sync in
    every training step on the card, and an error on ``meta``."""
    stepf = step.to(torch.float32)
    warm = cfg.lr * stepf / max(1, cfg.warmup_steps)
    table = _decay_table_on(cfg, step.device)
    idx = torch.clamp(step.long() - cfg.warmup_steps, 0, table.shape[0] - 1)
    decay = table.index_select(0, idx.reshape(1)).reshape(step.shape)
    return torch.where(stepf < cfg.warmup_steps, warm, decay)


def init_opt_state(params, moment_dtype="float32") -> dict:
    """Zero m and v moments of every leaf, and the step counter (int32, on
    the parameters' device)."""
    tree = _tree(params)
    dt = torch_dtype(moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(tree)[0][1].device
    return {"m": tree_map(zeros, tree), "v": tree_map(zeros, tree),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, in the
    reference's leaf order."""
    total = 0
    for _, g in tree_leaves(_tree(tree)):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm);
    the scale is cast to each gradient's dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(params, grads: dict, state: dict, cfg: OptConfig):
    """One AdamW step -> (params, new state, metrics): the parameters and
    moments written in place (module docstring), ``metrics`` holding
    ``grad_norm``, ``lr`` and ``skipped`` (1.0 when the norm was not finite,
    the update skipped) as 0-d tensors. Weight decay applies to leaves of
    two or more dimensions, counted on the stacked leaf: the layer-stacked
    (L, D) norm weights are decayed, the final norm (D,) is not."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        finite = torch.isfinite(gnorm)
        step = state["step"] + 1
        lr = lr_at(cfg, step)
        stepf = step.to(torch.float32)
        # a Python base to a float32 power: float32 (no host-to-device copy)
        b1c = 1.0 - torch.pow(cfg.b1, stepf)
        b2c = 1.0 - torch.pow(cfg.b2, stepf)
        gl = dict(tree_leaves(grads))
        ml, vl = dict(tree_leaves(state["m"])), dict(tree_leaves(state["v"]))
        for path, p in tree_leaves(_tree(params)):
            g, m, v = gl[path], ml[path], vl[path]
            gf = g.to(torch.float32)
            pf = p.to(torch.float32)
            m2 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
            v2 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(gf)
            delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * pf
            p2 = pf - lr * delta
            p.copy_(torch.where(finite, p2, pf))
            m.copy_(torch.where(finite, m2, m.to(torch.float32)))
            v.copy_(torch.where(finite, v2, v.to(torch.float32)))
        metrics = {"grad_norm": gnorm, "lr": lr,
                   "skipped": (~finite).to(torch.float32)}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
