"""``meta``-tensor stand-ins for every (arch × shape) cell (port of
``repro.launch.inputs``' single-card half).

``input_specs(arch, shape)`` returns exactly what the cell's step consumes,
as ``meta`` tensors (shapes and dtypes, no memory) where the JAX package
returns ``ShapeDtypeStruct``s:

- train cells:   (abstract trainable state, batch{tokens, labels, mask[,
                 patches|frames]})
- prefill cells: (abstract params, batch{tokens[, patches|frames]})
- decode cells:  (abstract params, tokens (B, 1), pos (B,), abstract cache)

with the logical-axis trees beside them (``state_axes``, ``param_axes``,
``cache_axes``) and the cell's ``rules`` (``rules_for_shape``: decode
shards the KV cache's length over ``model``, and long_500k's batch of one
over both axes).

With a ``mesh`` (a ``DeviceMesh``, ``launch.mesh.make_production_mesh``)
every tensor is a ``meta`` DTensor on it, placed by the cell's rules
(``sharding.rules.distribute_to``): its ``to_local()`` is rank 0's share.
``shardings_for`` and ``batch_shardings_for`` give each leaf's
``NamedSharding`` (its spec and its DTensor placements), as the reference
gives its jit's in- and out-shardings.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, tree_map
from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding import rules as shr
from repro_torch.train import step as train_step_mod

ENCDEC_SRC_LEN = api.ENCDEC_SRC_LEN


def rules_for_shape(shape: ShapeSpec) -> dict[str, Any]:
    r = dict(shr.DEFAULT_RULES)
    if shape.kind == "decode":
        if shape.global_batch == 1:
            r["batch"] = None
            r["kv_len"] = ("data", "model")
        else:
            r["kv_len"] = "model"
    if shape.kind == "prefill":
        r["kv_len"] = "model"
    return r


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def model_config_for(arch: str, shape: ShapeSpec) -> ModelConfig:
    return configs.tune_for_shape(configs.get_config(arch), shape)


def default_microbatches(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Grain-size control on the training side (paper Table I, DESIGN §4):
    split the global batch into grains so per-grain activations fit HBM.
    Baseline grains by model size."""
    n = api.n_params(cfg)
    if n >= 50e9:
        micro = 16
    elif n >= 3e9:
        micro = 4
    elif n >= 1e9:
        micro = 2
    else:
        micro = 1
    while shape.global_batch % micro:
        micro //= 2
    return max(1, micro)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract train/prefill batch for one cell."""
    B = shape.global_batch
    S = shape.seq_len
    d: dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        text = S - cfg.n_patches          # patches + text fill the budget
        d["tokens"] = _meta((B, text), torch.int32)
        d["patches"] = _meta((B, cfg.n_patches, cfg.vision_width), cfg.cdtype)
        if shape.kind == "train":
            d["labels"] = _meta((B, text), torch.int32)
    elif cfg.family == "encdec":
        src = min(ENCDEC_SRC_LEN, S)
        d["tokens"] = _meta((B, S), torch.int32)
        d["frames"] = _meta((B, src, cfg.vision_width), cfg.cdtype)
        if shape.kind == "train":
            d["labels"] = _meta((B, S), torch.int32)
    else:
        d["tokens"] = _meta((B, S), torch.int32)
        if shape.kind == "train":
            d["labels"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        d["mask"] = _meta((B, d["labels"].shape[1]), torch.float32)
    return d


def cache_specs_abstract(cfg: ModelConfig, shape: ShapeSpec):
    """(meta tree, logical-axes tree) for the decode cells' KV cache."""
    specs = api.cache_specs(cfg, shape.global_batch, shape.seq_len)
    return (tree_map(lambda t: _meta(t[0], t[1]), specs),
            tree_map(lambda t: t[2], specs))


def batch_axes(batch: dict) -> dict:
    """The batch leaves' logical axes: ``batch`` first, the rest whole."""
    return {k: ("batch",) + (None,) * (v.dim() - 1) for k, v in batch.items()}


def input_specs(arch: str, shape_name: str,
                cfg_overrides: dict | None = None,
                shape_overrides: dict | None = None,
                mesh=None) -> dict[str, Any]:
    """Everything the dry-run needs for one cell (abstract, no
    allocation). A train cell's params require grad, as ``make_state``'s
    do. ``shape_overrides`` cuts the shape (``global_batch``, ``seq_len``:
    a cell sized for one card's run, or a test's). With a ``mesh``, each
    tensor is a ``meta`` DTensor holding this rank's share (module
    docstring)."""
    shape = configs.SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    cfg = model_config_for(arch, shape)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    rules = rules_for_shape(shape)
    out: dict[str, Any] = {"cfg": cfg, "shape": shape, "rules": rules}
    place = ((lambda tree, axes: tree) if mesh is None else
             (lambda tree, axes: place_tree(mesh, tree, axes, rules)))
    if shape.kind == "train":
        # >=100B: bf16 moments + bf16 grad accumulation (update math fp32)
        big = api.n_params(cfg) >= 100e9
        out["moment_dtype"] = "bfloat16" if big else "float32"
        out["accum_dtype"] = "bfloat16" if big else "float32"
        out["state_axes"] = train_step_mod.state_axes(cfg)
        if mesh is None:
            out["state"] = train_step_mod.abstract_state(
                cfg, out["moment_dtype"], trainable=True)
        else:
            state = place(train_step_mod.abstract_state(
                cfg, out["moment_dtype"]), out["state_axes"])
            state["params"] = TransformerLM(cfg, state["params"],
                                            requires_grad=True)
            out["state"] = state
        out["batch"] = place(batch_specs(cfg, shape), None)
        out["n_microbatches"] = default_microbatches(cfg, shape)
    elif shape.kind == "prefill":
        out["param_axes"] = api.param_axes(cfg)
        out["params"] = place(api.abstract_params(cfg), out["param_axes"])
        out["batch"] = place(batch_specs(cfg, shape), None)
    else:  # decode
        out["param_axes"] = api.param_axes(cfg)
        out["params"] = place(api.abstract_params(cfg), out["param_axes"])
        B = shape.global_batch
        toks = {"tokens": _meta((B, 1), torch.int32),
                "pos": _meta((B,), torch.int32)}
        out.update(place(toks, None))
        cache, out["cache_axes"] = cache_specs_abstract(cfg, shape)
        out["cache"] = place(cache, out["cache_axes"])
    return out


# ---------------------------------------------------------------- shardings ----
def _paired(spec_tree, axes_tree):
    """(path, tensor, axes) of two parallel trees (a ``TransformerLM`` by
    its tree; ``axes_tree`` None: ``batch_axes``)."""
    if isinstance(spec_tree, TransformerLM):
        spec_tree = spec_tree.tree()
    if axes_tree is None:
        axes_tree = batch_axes(spec_tree)
    if isinstance(spec_tree, dict):
        for k, v in spec_tree.items():
            yield from ((f"{k}.{p}" if p else k, t, a)
                        for p, t, a in _paired(v, axes_tree[k]))
    else:
        yield "", spec_tree, tuple(axes_tree)


def _rebuild(spec_tree, leaves):
    if isinstance(spec_tree, TransformerLM):
        spec_tree = spec_tree.tree()
    if isinstance(spec_tree, dict):
        return {k: _rebuild(v, leaves) for k, v in spec_tree.items()}
    return next(leaves)


def place_tree(mesh, spec_tree, axes_tree, rules, init=None) -> Any:
    """Every leaf of ``spec_tree`` (``meta`` or real) as a DTensor on
    ``mesh`` under its logical axes (``axes_tree``; None for a batch);
    with ``init(local_shape, dtype)``, each rank's block made by ``init``
    (``sharding.rules.distribute_to``)."""
    leaves = iter([shr.distribute_to(mesh, t, a, rules, init=init)
                   for _, t, a in _paired(spec_tree, axes_tree)])
    return _rebuild(spec_tree, leaves)


def shardings_for(mesh, spec_tree, axes_tree, rules) -> Any:
    """Divisibility-aware ``NamedSharding``s for an abstract tree (each
    with its DTensor ``placements``)."""
    leaves = iter([shr.named_sharding_for(mesh, a, tuple(t.shape), rules)
                   for _, t, a in _paired(spec_tree, axes_tree)])
    return _rebuild(spec_tree, leaves)


def batch_shardings_for(mesh, batch: dict, rules) -> dict:
    return {
        k: shr.named_sharding_for(
            mesh, ("batch",) + (None,) * (len(v.shape) - 1), tuple(v.shape),
            rules)
        for k, v in batch.items()
    }
