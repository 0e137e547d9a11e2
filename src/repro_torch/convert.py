"""State carried across from the JAX package, as numpy.

The port imports no JAX, so the exchange format is numpy: a test (or a
migration script) calls ``np.asarray`` / ``jax.random.key_data`` on the JAX
side and hands the arrays here. That is what lets a search be stopped in
one package after round r and continued in the other, and a training run
started in both from one state (``train_state_from_numpy``).
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


def forest_from_numpy(fields: dict, device=None) -> Tree:
    """The forest twin of ``tree_from_numpy``: the nine fields of an
    E-member forest (every field with the member axis first, ``n_nodes``
    (E,)), e.g. ``np.asarray`` of a JAX forest's leaves. The arrays are
    copied."""
    forest = tree_from_numpy(fields, device)
    E = forest.n_nodes.shape
    if len(E) != 1 or any(t.shape[:1] != E or t.dim() < 2
                          for t in forest if t is not forest.n_nodes):
        raise ValueError(
            "forest_from_numpy: every field needs the member axis first and "
            f"n_nodes must be (E,); got shapes "
            f"{ {k: tuple(getattr(forest, k).shape) for k in _TREE_DTYPES} }")
    return forest


def tree_to_numpy(tree: Tree) -> dict:
    """The nine ``Tree`` fields as numpy arrays (int32 / float32); a
    forest's keep their member axis."""
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


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None,
                      requires_grad: bool = False) -> TransformerLM:
    """A ``TransformerLM`` from the JAX package's parameter tree given as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``):
    a decoder-only family's (``stage_i``, ``shared``, the vlm family's
    ``vision_proj``) or the encoder-decoder's (``embed``, ``frontend``,
    ``enc``, ``enc_norm``, ``dec``, ``final_norm``).

    Every leaf the config's spec tree has must be there, with its shape;
    nothing else may be. Arrays are copied and cast to ``cfg.param_dtype``
    (a bfloat16 array crosses as float32 first, which is exact).
    ``requires_grad`` makes a trainable module."""
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
    return TransformerLM(cfg, out, requires_grad=requires_grad)


def train_state_from_numpy(state: dict, cfg: ModelConfig, device=None,
                           moment_dtype: str = "float32") -> dict:
    """A training state (``train.step``'s: trainable params, the AdamW
    moments and step) from the JAX package's state given as nested dicts of
    numpy arrays (``jax.tree.map(np.asarray, state)``): ``{"params": ...,
    "opt": {"m": ..., "v": ..., "step": ()}}``. The moments must have the
    params' tree and shapes; they are cast to ``moment_dtype``."""
    device = torch.device("cuda") if device is None else torch.device(device)
    params = params_from_numpy(state["params"], cfg, device,
                               requires_grad=True)
    want = api.param_shapes(cfg)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype]
    opt: dict = {"m": {}, "v": {}}
    for name in ("m", "v"):
        got = dict(tree_leaves(state["opt"][name]))
        if set(got) != set(want):
            raise KeyError(f"train_state_from_numpy: opt/{name} leaves "
                           f"{sorted(set(got) ^ set(want))} differ from the "
                           "params'")
        for path, arr in got.items():
            arr = np.asarray(arr).astype(np.float32)
            if tuple(arr.shape) != tuple(want[path]):
                raise ValueError(f"train_state_from_numpy: opt/{name} {path} "
                                 f"has shape {arr.shape}, expected "
                                 f"{want[path]}")
            tree_set(opt[name], path, torch.tensor(arr, dtype=dt,
                                                   device=device))
    opt["step"] = torch.tensor(int(np.asarray(state["opt"]["step"])),
                               dtype=torch.int32, device=device)
    return {"params": params, "opt": opt}


def train_state_to_numpy(state: dict) -> dict:
    """The inverse: nested dicts of numpy arrays, the reference's tree
    (bfloat16 leaves as float32, the step an int32 0-d array)."""
    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    params = state["params"]
    params = params.tree() if isinstance(params, TransformerLM) else params
    out: dict = {"params": {}, "opt": {"m": {}, "v": {}}}
    for path, t in tree_leaves(params):
        tree_set(out["params"], path, host(t))
    for name in ("m", "v"):
        for path, t in tree_leaves(state["opt"][name]):
            tree_set(out["opt"][name], path, host(t))
    out["opt"]["step"] = host(state["opt"]["step"]).astype(np.int32)
    return out
