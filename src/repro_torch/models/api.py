"""Family-dispatched model API (port of ``repro.models.api``): one surface
over the decoder-only families (dense, vlm, MoE with or without MLA,
Mamba-2, the zamba2 hybrid, xLSTM: ``transformer.py``) and the
encoder-decoder family (``encdec.py``):

    specs(cfg)                              -> param Spec tree
    loss(params, cfg, batch)                -> scalar float32 loss
    cache_specs(cfg, batch, max_len)        -> {...: (shape, dtype, axes)}
    init_cache(cfg, batch, max_len, device=) -> zeroed cache tree
    prefill(params, cfg, batch, max_len)    -> (logits, cache)
    decode(params, cfg, token, pos, cache)  -> (logits, cache)   (cache in place)
    init_params(cfg, seed, device)          -> TransformerLM
    abstract_params(cfg)                    -> meta-tensor tree (no memory)
    param_axes(cfg)                         -> logical-axis tree

``prefill``'s batch holds ``tokens`` and, by family, the stub frontends'
inputs: ``patches`` (vlm: (B, n_patches, vision_width)) or ``frames``
(encdec: (B, S_src, frame_dim)); any other key is refused.

The cache trees nest as deep as the family's stages: ``{stage: {k, v}}``
for attention, ``{stage: {"mamba": {state, conv}, "attn": {k, v}}}`` for a
zamba2 segment, ``{stage: {"mlstm": {C, n, m, conv}, "slstm": {h, c, n, m,
conv}}}`` for an xLSTM segment, ``{"dec": {k, v, xk, xv}}`` for the
encoder-decoder (``xk``/``xv`` the memory's cross K/V, S_src long).
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ModelConfig, init_tree, spec_with_dtype,
                                       tree_axes, tree_leaves, tree_map,
                                       tree_specs)
from repro_torch.models.common import n_params as _n_params

# encoder memory length of the enc-dec decode shapes when the caller gives
# none (DESIGN.md §5's reading of the enc-dec decode cells)
ENCDEC_SRC_LEN = 4096


def specs(cfg: ModelConfig):
    if cfg.family == "encdec":
        return ed.encdec_specs(cfg)
    return tfm.lm_specs(cfg)


def loss(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The training loss: ``encdec_loss`` or ``lm_loss`` by family."""
    if cfg.family == "encdec":
        return ed.encdec_loss(params, cfg, batch)
    return tfm.lm_loss(params, cfg, batch)


def _src_len(max_len: int, src_len: int | None) -> int:
    return src_len or min(ENCDEC_SRC_LEN, max_len)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                src_len: int | None = None):
    if cfg.family == "encdec":
        return ed.encdec_cache_specs(cfg, batch, max_len,
                                     _src_len(max_len, src_len))
    return tfm.lm_cache_specs(cfg, batch, max_len)


def cache_batch_axes(cfg: ModelConfig, batch: int, max_len: int,
                     src_len: int | None = None) -> dict:
    """The cache tree's shape, each leaf its batch-axis index (leaves are
    layer-stacked: 1 for a stage's leaves, 2 for a segment's inner ones)."""
    return tree_map(lambda t: t[2].index("batch"),
                    cache_specs(cfg, batch, max_len, src_len))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               src_len: int | None = None, device=None):
    if cfg.family == "encdec":
        return ed.encdec_init_cache(cfg, batch, max_len,
                                    _src_len(max_len, src_len), device=device)
    return tfm.lm_init_cache(cfg, batch, max_len, device=device)


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int):
    extra = "frames" if cfg.family == "encdec" else "patches"
    unknown = set(batch) - {"tokens", extra}
    if unknown:
        raise ValueError(f"prefill batch keys {sorted(unknown)}: the "
                         f"{cfg.family} family takes 'tokens' and '{extra}'")
    if cfg.family == "encdec":
        if "frames" not in batch:
            raise ValueError("the encdec family needs a `frames` input (stub "
                             "frame embeddings (B, S_src, frame_dim))")
        return ed.encdec_prefill(params, cfg, batch["frames"],
                                 batch["tokens"], max_len)
    return tfm.lm_prefill(params, cfg, batch["tokens"], max_len,
                          patches=batch.get("patches"))


def decode(params, cfg: ModelConfig, token, pos, cache):
    if cfg.family == "encdec":
        return ed.encdec_decode(params, cfg, token, pos, cache)
    return tfm.lm_decode(params, cfg, token, pos, cache)


def n_params(cfg: ModelConfig) -> int:
    return _n_params(specs(cfg))


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                requires_grad: bool = False) -> tfm.TransformerLM:
    """Random weights from an explicit generator seeded with ``seed``, drawn
    on ``device`` (``None`` = CUDA) at the JAX package's scales. Not the JAX
    package's bits: parity tests convert its weights instead
    (``repro_torch.convert.params_from_numpy``). ``requires_grad`` makes a
    trainable module."""
    device = torch.device("cuda") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tree = init_tree(spec_with_dtype(specs(cfg), cfg.param_dtype), gen, device)
    return tfm.TransformerLM(cfg, tree, requires_grad=requires_grad)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors of the param dtype: shapes and
    dtypes, no memory (a checkpoint restore's template)."""
    return tree_specs(spec_with_dtype(specs(cfg), cfg.param_dtype))


def param_axes(cfg: ModelConfig) -> dict:
    """The parallel tree of logical-axis tuples."""
    return tree_axes(specs(cfg))


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Dotted parameter path -> shape (the ``state_dict`` layout)."""
    return {path: s.shape for path, s in tree_leaves(specs(cfg))}
