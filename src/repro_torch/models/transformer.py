"""Decoder-only LM, dense stage (port of ``repro.models.transformer`` for the
dense family): layer plan, block forward / prefill / decode, and the
explicit cache trees.

As in the JAX package, a model is a list of stages, each ``count`` copies of
one block with its parameters stacked along a leading ``layers`` axis; the
JAX package scans a stage, the port runs a Python loop over the layer index.
The KV cache is ``{"stage_i": {"k": (L, B, Smax, Hkv, hd), "v": ...}}``;
where the JAX package returns a new cache from every decode step, the port
writes the step's K/V into the cache it is given (in place) and returns it.

``TransformerLM`` wraps the parameter tree in an ``nn.Module`` whose
``state_dict`` keys are the JAX tree paths joined by ``.`` (for example
``stage_0.attn.wq``), so converting weights is name for name.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import (ModelConfig, check_dense, norm_spec,
                                       tree_leaves, tree_map, tree_set)
from repro_torch.models.layers import (embed, embed_specs, mlp, mlp_specs,
                                       rmsnorm, unembed)


# ------------------------------------------------------------- layer plan ----
def layer_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(kind, count)] stages; the dense family is one stage."""
    check_dense(cfg)
    return [("dense", cfg.n_layers)]


def _stack_specs(tree, n: int):
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n, *s.shape),
                                      axes=("layers", *s.axes)), tree)


# ------------------------------------------------------------ block: dense ----
def dense_block_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": norm_spec(d), "ln2": norm_spec(d),
            "attn": attn.gqa_specs(cfg), "mlp": mlp_specs(cfg)}


def dense_block_fwd(p, cfg: ModelConfig, x):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_attention(p["attn"], cfg, h)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h)


def dense_block_cache_specs(cfg: ModelConfig, batch: int, max_len: int, dtype):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    axes = ("batch", "kv_len", "kv_heads", None)
    return {"k": (shape, dtype, axes), "v": (shape, dtype, axes)}


def _pad_len(x: torch.Tensor, max_len: int) -> torch.Tensor:
    """Pad a (B, S, ...) prefill cache out to the max_len buffer."""
    S = x.shape[1]
    if S == max_len:
        return x
    pad = torch.zeros((x.shape[0], max_len - S, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


def dense_block_prefill(p, cfg: ModelConfig, x, max_len: int):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, (k, v) = attn.gqa_prefill(p["attn"], cfg, h)
    cache = {"k": _pad_len(k, max_len), "v": _pad_len(v, max_len)}
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h), cache


def dense_block_decode(p, cfg: ModelConfig, x, cache, pos):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, _ = attn.gqa_decode(p["attn"], cfg, h, (cache["k"], cache["v"]), pos)
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h), cache


# ------------------------------------------------------------------- specs ----
def lm_specs(cfg: ModelConfig) -> dict:
    p: dict = {"embed": embed_specs(cfg), "final_norm": norm_spec(cfg.d_model)}
    for i, (kind, count) in enumerate(layer_plan(cfg)):
        p[f"stage_{i}"] = _stack_specs(dense_block_specs(cfg), count)
    return p


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=None) -> dict:
    """{"stage_i": {"k"/"v": (shape, dtype, logical axes)}}, layer-stacked."""
    dtype = dtype or cfg.cdtype
    c: dict = {}
    for i, (kind, count) in enumerate(layer_plan(cfg)):
        block = dense_block_cache_specs(cfg, batch, max_len, dtype)
        c[f"stage_{i}"] = {name: ((count, *shape), dt, ("layers", *axes))
                           for name, (shape, dt, axes) in block.items()}
    return c


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> dict:
    device = torch.device("cuda") if device is None else torch.device(device)
    specs = lm_cache_specs(cfg, batch, max_len, dtype)
    return {stage: {name: torch.zeros(shape, dtype=dt, device=device)
                    for name, (shape, dt, _) in leaves.items()}
            for stage, leaves in specs.items()}


# ------------------------------------------------------------------ module ----
class TransformerLM(nn.Module):
    """The parameter tree as an ``nn.Module``: ``state_dict`` keys are the
    JAX tree paths joined by ``.``, and ``tree()`` gives the nested dict of
    tensors the model functions take. Parameters are inference weights
    (``requires_grad=False``): training is not ported (ROADMAP.md A13)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self._tree: dict = {}    # the same Parameters, nested as in JAX
        for path, t in tree_leaves(params):
            module = self
            *parents, name = path.split(".")
            for part in parents:
                if not hasattr(module, part):
                    module.add_module(part, nn.Module())
                module = getattr(module, part)
            param = nn.Parameter(t, requires_grad=False)
            module.register_parameter(name, param)
            tree_set(self._tree, path, param)
        self._layers = _layer_views(self._tree, cfg)

    def tree(self) -> dict:
        return self._tree


def as_tree(params) -> dict:
    return params.tree() if isinstance(params, TransformerLM) else params


def _layer_views(tree: dict, cfg: ModelConfig) -> list[list[dict]]:
    """Per stage, per layer: the layer's parameters as views into the
    stacked tensors."""
    return [[tree_map(lambda t, i=i: t[i], tree[f"stage_{s}"])
             for i in range(count)]
            for s, (_, count) in enumerate(layer_plan(cfg))]


def _layers(params, cfg: ModelConfig) -> list[list[dict]]:
    if isinstance(params, TransformerLM) and params.cfg == cfg:
        return params._layers   # built once: no per-step view bookkeeping
    return _layer_views(as_tree(params), cfg)


# ----------------------------------------------------------------- forward ----

def lm_hidden(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Tokens (B, S) -> final-norm hidden states (B, S, d)."""
    layers, params = _layers(params, cfg), as_tree(params)
    x = embed(params["embed"], tokens, cfg)
    for stage in layers:
        for lp in stage:
            x = dense_block_fwd(lp, cfg, x)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int):
    """Process a prompt; return (last-position logits (B, 1, V), cache)."""
    layers, params = _layers(params, cfg), as_tree(params)
    x = embed(params["embed"], tokens, cfg)
    caches = {}
    for i, stage in enumerate(layers):
        per_layer = []
        for lp in stage:
            x, c = dense_block_prefill(lp, cfg, x, max_len)
            per_layer.append(c)
        caches[f"stage_{i}"] = {name: torch.stack([c[name] for c in per_layer])
                                for name in ("k", "v")}
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h[:, -1:, :], cfg), caches


def lm_decode(params, cfg: ModelConfig, token: torch.Tensor, pos, cache: dict):
    """One decode step. token: (B, 1) ids; pos: a Python int (every row at
    the same position) or a (B,) tensor. The cache is written in place and
    returned with the logits (B, 1, V)."""
    layers, params = _layers(params, cfg), as_tree(params)
    x = embed(params["embed"], token, cfg)
    for i, stage in enumerate(layers):
        sc = cache[f"stage_{i}"]
        for layer, lp in enumerate(stage):
            lc = {"k": sc["k"][layer], "v": sc["v"][layer]}
            x, _ = dense_block_decode(lp, cfg, x, lc, pos)
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h, cfg), cache

