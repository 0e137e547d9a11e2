"""State carried across from the JAX package, as numpy.

The port imports no JAX, so the exchange format is numpy: a test (or a
migration script) calls ``np.asarray`` / ``jax.random.key_data`` on the JAX
side and hands the arrays here. That is what lets a search be stopped in
one package after round r and continued in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gscpm import GSCPMConfig
from repro_torch.core.tree import Tree
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, tree_leaves, tree_set
from repro_torch.models.transformer import TransformerLM

_TREE_DTYPES = {
    "parent": torch.int32, "move": torch.int32, "to_move": torch.int32,
    "children": torch.int32, "n_children": torch.int32,
    "visits": torch.float32, "wins": torch.float32, "vloss": torch.float32,
    "n_nodes": torch.int32,
}


def tree_from_numpy(fields: dict, device=None) -> Tree:
    """Build a ``Tree`` from a dict of the nine fields (same names, shapes
    and dtypes as the JAX package's ``Tree``). The arrays are copied."""
    device = torch.device("cuda") if device is None else torch.device(device)
    missing = set(_TREE_DTYPES) - set(fields)
    if missing:
        raise KeyError(f"tree_from_numpy: missing fields {sorted(missing)}")
    return Tree(**{
        name: torch.tensor(np.asarray(fields[name]), dtype=dt, device=device)
        for name, dt in _TREE_DTYPES.items()})


def tree_to_numpy(tree: Tree) -> dict:
    """The nine ``Tree`` fields as numpy arrays (int32 / float32)."""
    return {name: getattr(tree, name).detach().cpu().numpy()
            for name in _TREE_DTYPES}


def key_from_data(data, device=None) -> torch.Tensor:
    """A port key from the two uint32 words of ``jax.random.key_data(k)``
    (any leading batch axes are kept)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    arr = np.asarray(data)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"key data must end in 2 words, got shape {arr.shape}")
    return torch.tensor(arr.astype(np.int64) & 0xFFFFFFFF, dtype=torch.int64,
                        device=device)


def config_from_dict(d: dict) -> GSCPMConfig:
    """A ``GSCPMConfig`` from ``dataclasses.asdict`` of either package's
    config (the two have the same fields); unknown keys are refused."""
    names = {f.name for f in dataclasses.fields(GSCPMConfig)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"config_from_dict: unknown fields {sorted(unknown)}")
    return GSCPMConfig(**d)


def model_config_from_dict(d: dict) -> ModelConfig:
    """A ``ModelConfig`` from ``dataclasses.asdict`` of either package's
    config (the two have the same fields); unknown keys are refused."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"model_config_from_dict: unknown fields {sorted(unknown)}")
    return ModelConfig(**d)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> TransformerLM:
    """A ``TransformerLM`` from the JAX package's parameter tree given as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``).

    Every leaf the config's spec tree has must be there, with its shape;
    nothing else may be. Arrays are copied and cast to ``cfg.param_dtype``
    (a bfloat16 array crosses as float32 first, which is exact)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    want = api.param_shapes(cfg)
    got = dict(tree_leaves(tree))
    missing, unknown = set(want) - set(got), set(got) - set(want)
    if missing or unknown:
        raise KeyError(f"params_from_numpy: missing {sorted(missing)}, "
                       f"unknown {sorted(unknown)}")
    out: dict = {}
    for path, arr in got.items():
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(want[path]):
            raise ValueError(f"params_from_numpy: {path} has shape "
                             f"{arr.shape}, expected {want[path]}")
        tree_set(out, path, torch.tensor(arr.astype(np.float32),
                                         dtype=cfg.pdtype, device=device))
    return TransformerLM(cfg, out)
