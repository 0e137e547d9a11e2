"""``meta``-tensor stand-ins for every (arch × shape) cell (port of
``repro.launch.inputs``' single-card half).

``input_specs(arch, shape)`` returns exactly what the cell's step consumes,
as ``meta`` tensors (shapes and dtypes, no memory) where the JAX package
returns ``ShapeDtypeStruct``s:

- train cells:   (abstract trainable state, batch{tokens, labels, mask[,
                 patches|frames]})
- prefill cells: (abstract params, batch{tokens[, patches|frames]})
- decode cells:  (abstract params, tokens (B, 1), pos (B,), abstract cache)

The sharding half — ``rules_for_shape``, ``shardings_for``,
``batch_shardings_for`` — is the multi-card row of ROADMAP.md, item A14b
(the sharded analysis): those names exist and refuse, naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, tree_map
from repro_torch.train import step as train_step_mod

ENCDEC_SRC_LEN = api.ENCDEC_SRC_LEN
MULTI_CARD = "the multi-card row of ROADMAP.md (A14b, the sharded analysis)"


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


def input_specs(arch: str, shape_name: str,
                cfg_overrides: dict | None = None,
                shape_overrides: dict | None = None) -> dict[str, Any]:
    """Everything the dry-run needs for one cell (abstract, no
    allocation). A train cell's params require grad, as ``make_state``'s
    do. ``shape_overrides`` cuts the shape (``global_batch``, ``seq_len``:
    a cell sized for one card's run, or a test's)."""
    shape = configs.SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    cfg = model_config_for(arch, shape)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    out: dict[str, Any] = {"cfg": cfg, "shape": shape}
    if shape.kind == "train":
        # >=100B: bf16 moments + bf16 grad accumulation (update math fp32)
        big = api.n_params(cfg) >= 100e9
        out["moment_dtype"] = "bfloat16" if big else "float32"
        out["accum_dtype"] = "bfloat16" if big else "float32"
        out["state"] = train_step_mod.abstract_state(
            cfg, out["moment_dtype"], trainable=True)
        out["batch"] = batch_specs(cfg, shape)
        out["n_microbatches"] = default_microbatches(cfg, shape)
    elif shape.kind == "prefill":
        out["params"] = api.abstract_params(cfg)
        out["batch"] = batch_specs(cfg, shape)
    else:  # decode
        out["params"] = api.abstract_params(cfg)
        out["tokens"] = _meta((shape.global_batch, 1), torch.int32)
        out["pos"] = _meta((shape.global_batch,), torch.int32)
        out["cache"] = cache_specs_abstract(cfg, shape)[0]
    return out


# ---------------------------------------------------------------- shardings ----
def _refuse(name: str):
    raise NotImplementedError(
        f"{name}: sharding rules and meshes are {MULTI_CARD}; the port's "
        "dry-run runs on one card")


def rules_for_shape(shape: ShapeSpec):
    _refuse("rules_for_shape")


def shardings_for(mesh, spec_tree, axes_tree, rules):
    _refuse("shardings_for")


def batch_shardings_for(mesh, batch: dict, rules):
    _refuse("batch_shardings_for")
