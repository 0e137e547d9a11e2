"""Training step on one card: loss + grad + AdamW, microbatched (port of
``repro.train.step``'s single-card half).

**Grain size control, the training-side analogue** (DESIGN.md §4): the
global batch is split into ``n_microbatches`` grains, each a forward and a
backward, their gradients accumulated in ``accum_dtype`` (float32). As with
the paper's nTasks dial, more grains trade per-step live activation memory
against loop overhead; the gradients do not change (the grain is
numerically neutral, ``tests/test_torch_train_step.py``).

The state is ``{"params": TransformerLM (trainable), "opt": {"m", "v",
"step"}}``, the reference's tree: it flattens to the reference's checkpoint
keys (``checkpoint.store``). The step updates it in place and returns it.

The multi-card half — ``make_train_step_compressed`` (int8 gradients across
pods), ``state_shardings``, ``batch_shardings``, ``jit_train_step`` — is the
multi-card row of ROADMAP.md, item A14c: those names exist and refuse,
naming it.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import api
from repro_torch.models.common import (ModelConfig, torch_dtype, tree_leaves,
                                       tree_map, tree_set)
from repro_torch.models.transformer import TransformerLM, as_tree
from repro_torch.optim import adamw

BATCH_KEYS = ("tokens", "labels", "mask", "patches", "frames")
MULTI_CARD = "the multi-card row of ROADMAP.md (A14c, multi-card training)"


def _device(device) -> torch.device:
    return torch.device("cuda") if device is None else torch.device(device)


def make_state(cfg: ModelConfig, seed: int = 0,
               moment_dtype: str = "float32", device=None) -> dict:
    """Fresh trainable weights from ``seed`` (``api.init_params``) and zero
    moments, on ``device`` (``None`` = CUDA)."""
    params = api.init_params(cfg, seed, _device(device), requires_grad=True)
    return {"params": params,
            "opt": adamw.init_opt_state(params, moment_dtype)}


def abstract_state(cfg: ModelConfig, moment_dtype: str = "float32",
                   trainable: bool = False) -> dict:
    """The state tree as ``meta`` tensors (no memory): a restore's
    template. ``trainable``: the params a ``TransformerLM`` whose leaves
    require grad, as ``make_state``'s do (the dry-run's train step)."""
    params = api.abstract_params(cfg)
    if trainable:
        params = TransformerLM(cfg, params, requires_grad=True)
    mdt = torch_dtype(moment_dtype)
    mom = lambda p: torch.empty(p.shape, dtype=mdt, device="meta")
    tree = as_tree(params)
    return {"params": params,
            "opt": {"m": tree_map(mom, tree), "v": tree_map(mom, tree),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def state_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tree parallel to the state (moments like params)."""
    axes = api.param_axes(cfg)
    return {"params": axes,
            "opt": {"m": tree_map(lambda a: a, axes),
                    "v": tree_map(lambda a: a, axes), "step": ()}}


def trainable_state(cfg: ModelConfig, state: dict) -> dict:
    """A state whose ``params`` is a dict tree (a restore's) with its
    params as a trainable ``TransformerLM``, the tensors shared."""
    params = state["params"]
    if not isinstance(params, TransformerLM):
        params = TransformerLM(cfg, params, requires_grad=True)
    return {"params": params, "opt": state["opt"]}


def _split_micro(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...) for every present batch leaf. A DTensor
    leaf split over its batch is gathered whole first (a microbatch spans
    a few ranks' rows; the model's first annotation splits each again)."""
    def sp(x):
        B = x.shape[0]
        assert B % n == 0, (B, n)
        if isinstance(x, DTensor) and n > 1:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard(0) else p for p in x.placements])
        return x.reshape(n, B // n, *x.shape[1:])
    return {k: sp(v) for k, v in batch.items() if k in BATCH_KEYS}


def _value_and_grad(cfg: ModelConfig, params, batch: dict):
    """(loss, {path: grad}) of ``api.loss`` at ``params``."""
    leaves = tree_leaves(as_tree(params))
    loss = api.loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.detach(), dict(zip((path for path, _ in leaves), grads))


def _as_tree(flat: dict) -> dict:
    out: dict = {}
    for path, g in flat.items():
        tree_set(out, path, g)
    return out


def _mean_grads(cfg: ModelConfig, params, batch: dict, n_micro: int,
                accum_dtype=torch.float32):
    """Microbatch-accumulated (loss, grads), the grain-size loop. One grain:
    the gradients in the parameters' dtype. Several: each grain's gradients
    added into ``accum_dtype`` zeros in grain order, then scaled by
    ``1 / n_micro`` — staying in ``accum_dtype``, as the reference's do
    (its final cast is to the accumulator's own dtype)."""
    if n_micro <= 1:
        loss, grads = _value_and_grad(cfg, params, batch)
        return loss, _as_tree(grads)
    micro = _split_micro(batch, n_micro)
    leaves = tree_leaves(as_tree(params))
    acc = {path: torch.zeros_like(p, dtype=accum_dtype)
           if isinstance(p, DTensor) else
           torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
           for path, p in leaves}
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0][1].device)
    for i in range(n_micro):
        loss, g = _value_and_grad(cfg, params,
                                  {k: v[i] for k, v in micro.items()})
        loss_sum = loss_sum + loss
        for path, a in acc.items():
            a.add_(g[path].to(a.dtype))
        del g
    inv = 1.0 / n_micro
    return loss_sum * inv, _as_tree({p: a * inv for p, a in acc.items()})


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    n_microbatches: int = 1, accum_dtype=torch.float32):
    """The single-card train step: (state, batch) -> (state, metrics), the
    state updated in place; metrics ``loss``, ``grad_norm``, ``lr`` and
    ``skipped`` as 0-d tensors."""

    def step(state: dict, batch: dict):
        loss, grads = _mean_grads(cfg, state["params"], batch,
                                  n_microbatches, accum_dtype)
        params, opt, metrics = adamw.adamw_update(
            state["params"], grads, state["opt"], opt_cfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return step


def _refuse(name: str):
    raise NotImplementedError(
        f"{name}: sharded and multi-card training is {MULTI_CARD}; this "
        "port trains on one card")


def make_train_step_compressed(cfg, opt_cfg, mesh, n_microbatches: int = 1,
                               pod_axis: str = "pod"):
    _refuse("make_train_step_compressed")


def state_shardings(mesh, cfg, rules=None):
    _refuse("state_shardings")


def batch_shardings(mesh, batch_tree, rules=None):
    _refuse("batch_shardings")


def jit_train_step(step_fn, mesh, cfg, batch_tree, rules=None,
                   donate: bool = True):
    _refuse("jit_train_step")
