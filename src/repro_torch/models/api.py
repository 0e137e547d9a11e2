"""Family-dispatched model API (port of ``repro.models.api`` for the
decoder-only families: dense, MoE with or without MLA, Mamba-2, the zamba2
hybrid and xLSTM):

    specs(cfg)                              -> param Spec tree
    cache_specs(cfg, batch, max_len)        -> {stage: {...: (shape, dtype, axes)}}
    init_cache(cfg, batch, max_len, device) -> zeroed cache tree
    prefill(params, cfg, batch, max_len)    -> (logits, cache)
    decode(params, cfg, token, pos, cache)  -> (logits, cache)   (cache in place)
    init_params(cfg, seed, device)          -> TransformerLM

The cache trees nest as deep as the family's stages: ``{stage: {k, v}}``
for attention, ``{stage: {"mamba": {state, conv}, "attn": {k, v}}}`` for a
zamba2 segment, ``{stage: {"mlstm": {C, n, m, conv}, "slstm": {h, c, n, m,
conv}}}`` for an xLSTM segment. The vlm and encoder-decoder families raise
``NotImplementedError`` (``models.common.check_in_slice``; ROADMAP.md item
A12c).
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ModelConfig, init_tree, spec_with_dtype,
                                       tree_leaves, tree_map)
from repro_torch.models.common import n_params as _n_params


def specs(cfg: ModelConfig):
    return tfm.lm_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    return tfm.lm_cache_specs(cfg, batch, max_len)


def cache_batch_axes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache tree's shape, each leaf its batch-axis index (leaves are
    layer-stacked: 1 for a stage's leaves, 2 for a segment's inner ones)."""
    return tree_map(lambda t: t[2].index("batch"),
                    cache_specs(cfg, batch, max_len))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return tfm.lm_init_cache(cfg, batch, max_len, device=device)


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int):
    extra = set(batch) - {"tokens"}
    if extra:
        raise NotImplementedError(
            f"prefill batch keys {sorted(extra)}: the vlm/encdec inputs are "
            "not ported (ROADMAP.md item A12c)")
    return tfm.lm_prefill(params, cfg, batch["tokens"], max_len)


def decode(params, cfg: ModelConfig, token, pos, cache):
    return tfm.lm_decode(params, cfg, token, pos, cache)


def n_params(cfg: ModelConfig) -> int:
    return _n_params(specs(cfg))


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> tfm.TransformerLM:
    """Random weights from an explicit generator seeded with ``seed``, drawn
    on ``device`` (``None`` = CUDA) at the JAX package's scales. Not the JAX
    package's bits: parity tests convert its weights instead
    (``repro_torch.convert.params_from_numpy``)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tree = init_tree(spec_with_dtype(specs(cfg), cfg.param_dtype), gen, device)
    return tfm.TransformerLM(cfg, tree)


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Dotted parameter path -> shape (the ``state_dict`` layout)."""
    return {path: s.shape for path, s in tree_leaves(specs(cfg))}
