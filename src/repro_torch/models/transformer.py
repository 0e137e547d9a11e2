"""Decoder-only LM (port of ``repro.models.transformer``): layer plan,
blocks (dense / MoE / MLA attention, Mamba-2, mLSTM, the xLSTM and zamba2
segments), their forward / prefill / decode, the explicit cache trees, and
the vlm family's prefix: gemma's embedding scale, the ``vision_proj``
projection of stub patch embeddings, prefix-LM attention over
[patches | prompt].

As in the JAX package, a model is a list of stages, each ``count`` copies of
one block kind with its parameters stacked along a leading ``layers`` axis;
the heterogeneous families (zamba2, xLSTM) are composite segment kinds whose
inner layers are stacked once more. The JAX package scans a stage; the port
runs a Python loop over per-layer views of the stacked tensors
(``_stage_views``). The cache tree mirrors the stages (``{"stage_i":
{leaf: (L, [inner,] B, ...)}}``, attention K/V with ``kv_len`` after the
batch axis); where the JAX package returns a new cache from every decode
step, the port writes the step's K/V and recurrent states into the cache it
is given (in place) and returns it.

``TransformerLM`` wraps the parameter tree in an ``nn.Module`` whose
``state_dict`` keys are the JAX tree paths joined by ``.`` (for example
``stage_0.attn.wq``), so converting weights is name for name.

Training: ``lm_loss`` (the next-token cross-entropy, over the vlm family's
text tail only) differentiates through every block, the kernels included
(``kernels._autograd``); ``cfg.remat`` ``"full"`` or ``"dots"`` recomputes
each layer (a zamba2 segment, an xLSTM segment) in the backward
(``_maybe_remat``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.models import attention as attn
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (ModelConfig, dense_spec, norm_spec,
                                       store_layer, tree_leaves, tree_map,
                                       tree_set, unstack)
from repro_torch.models.layers import (chunked_ce_loss, embed, embed_specs,
                                       mlp, mlp_specs, rmsnorm, unembed)
from repro_torch.sharding import rules as shr
from repro_torch.sharding.rules import shard


# ------------------------------------------------------------- layer plan ----
def layer_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(kind, count)] stages; each stage is one homogeneous stack."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return [("dense", cfg.n_layers)]
    if fam == "moe":
        plan = []
        if cfg.n_dense_layers:
            plan.append(("dense", cfg.n_dense_layers))
        plan.append(("moe", cfg.n_layers - cfg.n_dense_layers))
        return plan
    if fam == "ssm":
        return [("mamba", cfg.n_layers)]
    if fam in ("xlstm", "hybrid"):
        seg_kind, k, rest = (("xlstm_seg", cfg.slstm_every, "mlstm")
                             if fam == "xlstm"
                             else ("zamba_seg", cfg.attn_every, "mamba"))
        segs, rem = divmod(cfg.n_layers, k)
        plan = []
        if segs:
            plan.append((seg_kind, segs))
        if rem:
            plan.append((rest, rem))
        return plan
    raise ValueError(f"unknown family {fam}")


def _stack_specs(tree, n: int):
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n, *s.shape),
                                      axes=("layers", *s.axes)), tree)


def _stack_cache_specs(tree, n: int):
    """Cache specs are (shape, dtype, axes) leaves."""
    return tree_map(lambda t: ((n, *t[0]), t[1], ("layers", *t[2])), tree)


def _maybe_remat(f, cfg: ModelConfig):
    """``f`` recomputed in the backward (``torch.utils.checkpoint``, not
    reentrant) when ``cfg.remat`` is ``"full"`` or ``"dots"``; ``f`` itself
    otherwise. Numerically neutral. ``"dots"``, the reference's policy of
    saving the matmul outputs without batch dims, checkpoints the whole
    layer here: PyTorch has no such policy, and saving less only costs
    more recompute."""
    if cfg.remat not in ("full", "dots"):
        return f

    def remat(*args, **kw):
        if not torch.is_grad_enabled():
            return f(*args, **kw)
        return _ckpt.checkpoint(shr.under_current_rules(f), *args,
                                use_reentrant=False, **kw)
    return remat


def _edge(x):
    """The block edge's annotation: (batch, act_seq, embed-whole)."""
    return shard(x, ("batch", "act_seq", None))


def _ffn(p, cfg: ModelConfig, h):
    return moe_mod.moe_ffn(p["moe"], cfg, h) if "moe" in p else mlp(p["mlp"], cfg, h)


# ------------------------------------------------------ block: dense / moe ----
def dense_block_specs(cfg: ModelConfig, use_moe: bool = False) -> dict:
    d = cfg.d_model
    s = {"ln1": norm_spec(d), "ln2": norm_spec(d)}
    s["attn"] = attn.mla_specs(cfg) if cfg.use_mla else attn.gqa_specs(cfg)
    if use_moe:
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    return s


def dense_block_fwd(p, cfg: ModelConfig, x, prefix_len: int = 0):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a = attn.mla_attention(p["attn"], cfg, h)
    elif prefix_len == 0:
        a = attn.gqa_attention(p["attn"], cfg, h)
    else:
        a = attn.gqa_prefix_attention(p["attn"], cfg, h, prefix_len)
    x = _edge(x + a)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return _edge(x + _ffn(p, cfg, h))


def dense_block_cache_specs(cfg: ModelConfig, batch: int, max_len: int, dtype):
    if cfg.use_mla:
        return {"c_kv": ((batch, max_len, cfg.kv_lora_rank), dtype,
                         ("batch", "kv_len", None)),
                "k_pe": ((batch, max_len, cfg.qk_rope_head_dim), dtype,
                         ("batch", "kv_len", None))}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    axes = ("batch", "kv_len", "kv_heads", None)
    return {"k": (shape, dtype, axes), "v": (shape, dtype, axes)}


def check_fits(S: int, max_len: int) -> None:
    """A prefill of S positions must fit its max_len cache: above it raises
    ``ValueError``, as the reference's ``jnp.pad`` in ``_pad_len`` does.
    The prefill entry points check before any work."""
    if S > max_len:
        raise ValueError(f"a prefill of {S} positions does not fit a cache "
                         f"of max_len {max_len}")


def _pad_len(x: torch.Tensor, max_len: int) -> torch.Tensor:
    """Pad a (B, S, ...) prefill cache out to the max_len buffer (S <=
    max_len: ``check_fits`` ran first)."""
    S = x.shape[1]
    if S == max_len:
        return x
    pad = torch.zeros((x.shape[0], max_len - S, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


def dense_block_prefill(p, cfg: ModelConfig, x, max_len: int,
                        prefix_len: int = 0):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, (c_kv, k_pe) = attn.mla_prefill(p["attn"], cfg, h)
        cache = {"c_kv": _pad_len(c_kv, max_len),
                 "k_pe": _pad_len(k_pe, max_len)}
    else:
        a, (k, v) = attn.gqa_prefill(p["attn"], cfg, h, prefix_len=prefix_len)
        cache = {"k": _pad_len(k, max_len), "v": _pad_len(v, max_len)}
    x = _edge(x + a)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return _edge(x + _ffn(p, cfg, h)), cache


def dense_block_decode(p, cfg: ModelConfig, x, cache, pos):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, _ = attn.mla_decode(p["attn"], cfg, h,
                               (cache["c_kv"], cache["k_pe"]), pos)
    else:
        a, _ = attn.gqa_decode(p["attn"], cfg, h, (cache["k"], cache["v"]), pos)
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(p, cfg, h), cache


# ------------------------------------------------------------ block: mamba ----
def mamba_block_specs(cfg: ModelConfig) -> dict:
    return {"ln": norm_spec(cfg.d_model), "ssm": ssm_mod.mamba2_specs(cfg)}


def mamba_block_fwd(p, cfg, x):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    return _edge(x + ssm_mod.mamba2_forward(p["ssm"], cfg, h))


def mamba_block_cache_specs(cfg, batch, max_len, dtype):
    return ssm_mod.mamba2_cache_specs(cfg, batch, dtype)


def mamba_block_prefill(p, cfg, x, max_len):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    y, cache = ssm_mod.mamba2_forward(p["ssm"], cfg, h, return_cache=True)
    return _edge(x + y), cache


def mamba_block_decode(p, cfg, x, cache, pos):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    y, cache = ssm_mod.mamba2_decode(p["ssm"], cfg, h, cache)
    return x + y, cache


# ------------------------------------------------------------ block: mlstm ----
def mlstm_block_fwd(p, cfg, x):
    return _edge(x + xlstm_mod.mlstm_forward(p, cfg, x))


def mlstm_block_prefill(p, cfg, x, max_len):
    y, cache = xlstm_mod.mlstm_prefill(p, cfg, x)
    return _edge(x + y), cache


def mlstm_block_decode(p, cfg, x, cache, pos):
    y, cache = xlstm_mod.mlstm_decode(p, cfg, x, cache)
    return x + y, cache


# -------------------------------------------------------- block: xlstm_seg ----
def xlstm_seg_specs(cfg: ModelConfig) -> dict:
    return {"mlstm": _stack_specs(xlstm_mod.mlstm_specs(cfg),
                                  cfg.slstm_every - 1),
            "slstm": xlstm_mod.slstm_specs(cfg)}


def xlstm_seg_fwd(p, cfg, x):
    for lp in p["mlstm"]:
        x = mlstm_block_fwd(lp, cfg, x)
    return _edge(x + xlstm_mod.slstm_forward(p["slstm"], cfg, x))


def xlstm_seg_cache_specs(cfg, batch, max_len, dtype):
    return {"mlstm": _stack_cache_specs(
        xlstm_mod.mlstm_cache_specs(cfg, batch, dtype), cfg.slstm_every - 1),
        "slstm": xlstm_mod.slstm_cache_specs(cfg, batch, dtype)}


def xlstm_seg_prefill(p, cfg, x, max_len):
    m_caches = None
    for j, lp in enumerate(p["mlstm"]):
        x, c = mlstm_block_prefill(lp, cfg, x, max_len)
        m_caches = store_layer(m_caches, j, len(p["mlstm"]), c)
    y, s_cache = xlstm_mod.slstm_prefill(p["slstm"], cfg, x)
    return _edge(x + y), {"mlstm": m_caches, "slstm": s_cache}


def xlstm_seg_decode(p, cfg, x, cache, pos):
    for j, lp in enumerate(p["mlstm"]):
        lc = tree_map(lambda t, j=j: t[j], cache["mlstm"])
        x, _ = mlstm_block_decode(lp, cfg, x, lc, pos)
    y, _ = xlstm_mod.slstm_decode(p["slstm"], cfg, x, cache["slstm"])
    return x + y, cache


# ----------------------------------------------------------------- registry ----
_BLOCKS: dict[str, dict] = {
    "dense": dict(specs=lambda cfg: dense_block_specs(cfg, use_moe=False),
                  fwd=dense_block_fwd, cache=dense_block_cache_specs,
                  prefill=dense_block_prefill, decode=dense_block_decode),
    "moe": dict(specs=lambda cfg: dense_block_specs(cfg, use_moe=True),
                fwd=dense_block_fwd, cache=dense_block_cache_specs,
                prefill=dense_block_prefill, decode=dense_block_decode),
    "mamba": dict(specs=mamba_block_specs, fwd=mamba_block_fwd,
                  cache=mamba_block_cache_specs, prefill=mamba_block_prefill,
                  decode=mamba_block_decode),
    "mlstm": dict(specs=xlstm_mod.mlstm_specs, fwd=mlstm_block_fwd,
                  cache=lambda cfg, b, m, dt: xlstm_mod.mlstm_cache_specs(cfg, b, dt),
                  prefill=mlstm_block_prefill, decode=mlstm_block_decode),
    "xlstm_seg": dict(specs=xlstm_seg_specs, fwd=xlstm_seg_fwd,
                      cache=xlstm_seg_cache_specs, prefill=xlstm_seg_prefill,
                      decode=xlstm_seg_decode),
    # the shared blocks' params are passed in: see _run_stage and friends
    "zamba_seg": dict(specs=hybrid_mod.zamba_seg_specs, fwd=None,
                      cache=hybrid_mod.zamba_seg_cache_specs,
                      prefill=None, decode=None),
}


# ------------------------------------------------------------------- specs ----
def lm_specs(cfg: ModelConfig) -> dict:
    p: dict = {"embed": embed_specs(cfg), "final_norm": norm_spec(cfg.d_model)}
    for i, (kind, count) in enumerate(layer_plan(cfg)):
        p[f"stage_{i}"] = _stack_specs(_BLOCKS[kind]["specs"](cfg), count)
    if cfg.family == "hybrid":
        p["shared"] = _stack_specs(dense_block_specs(cfg), cfg.n_shared_blocks)
    if cfg.family == "vlm":
        p["vision_proj"] = dense_spec(cfg.vision_width, cfg.d_model,
                                      ("embed", None))
    return p


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=None) -> dict:
    """{"stage_i": {leaf or segment: ...}} of (shape, dtype, logical axes)
    leaves, layer-stacked."""
    dtype = dtype or cfg.cdtype
    return {f"stage_{i}": _stack_cache_specs(
        _BLOCKS[kind]["cache"](cfg, batch, max_len, dtype), count)
        for i, (kind, count) in enumerate(layer_plan(cfg))}


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> dict:
    """A zeroed cache. Zero is a valid start everywhere: the mLSTM/sLSTM
    stabilizer m only weights the (zero) C/n contributions, so m = 0 is
    equivalent to -inf."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return tree_map(lambda t: torch.zeros(t[0], dtype=t[1], device=device),
                    lm_cache_specs(cfg, batch, max_len, dtype))


# ------------------------------------------------------------------ module ----
class TransformerLM(nn.Module):
    """The parameter tree as an ``nn.Module``: ``state_dict`` keys are the
    JAX tree paths joined by ``.``, and ``tree()`` gives the nested dict of
    tensors the model functions take. It holds the encoder-decoder family's
    tree (``models.encdec``) as well. ``requires_grad`` is chosen at
    construction: ``False`` (serving's inference weights, the default) or
    ``True`` (trainable: ``train.step`` differentiates the loss in every
    leaf and updates the leaves in place)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 requires_grad: bool = False):
        super().__init__()
        self.cfg = cfg
        self.trainable = requires_grad
        self._tree: dict = {}    # the same Parameters, nested as in JAX
        for path, t in tree_leaves(params):
            module = self
            *parents, name = path.split(".")
            for part in parents:
                if not hasattr(module, part):
                    module.add_module(part, nn.Module())
                module = getattr(module, part)
            param = nn.Parameter(t, requires_grad=requires_grad)
            module.register_parameter(name, param)
            tree_set(self._tree, path, param)
        with torch.no_grad():    # serving's views: no autograd history
            self._layers = _layer_views(self._tree, cfg)

    def tree(self) -> dict:
        return self._tree


def as_tree(params) -> dict:
    return params.tree() if isinstance(params, TransformerLM) else params


def _stage_views(kind: str, tree: dict, count: int, cfg: ModelConfig) -> list:
    """A stage's per-layer parameter views; a segment's inner stacks are
    per-layer lists too."""
    layers = unstack(tree, count)
    if kind == "xlstm_seg":
        return [{"mlstm": unstack(lp["mlstm"], cfg.slstm_every - 1),
                 "slstm": lp["slstm"]} for lp in layers]
    if kind == "zamba_seg":
        return [{"mamba": unstack(lp["mamba"], cfg.attn_every)}
                for lp in layers]
    return layers


def _layer_views(tree: dict, cfg: ModelConfig) -> tuple[list, list | None]:
    """(per stage, per layer: the layer's parameters as views into the
    stacked tensors; the hybrid family's shared blocks as views, or None).
    For the encoder-decoder family: (the encoder's layers, the decoder's)."""
    if cfg.family == "encdec":
        return (unstack(tree["enc"], cfg.n_enc_layers),
                unstack(tree["dec"], cfg.n_layers))
    stages = [_stage_views(kind, tree[f"stage_{s}"], count, cfg)
              for s, (kind, count) in enumerate(layer_plan(cfg))]
    shared = (unstack(tree["shared"], cfg.n_shared_blocks)
              if "shared" in tree else None)
    return stages, shared


def _layers(params, cfg: ModelConfig) -> tuple[list, list | None]:
    """Per-layer views: built once for serving (no per-step view
    bookkeeping); made anew for a forward that records gradients, so each
    step's views carry them into the stacked leaves (and see the last
    in-place update)."""
    if (isinstance(params, TransformerLM) and params.cfg == cfg
            and not (params.trainable and torch.is_grad_enabled())):
        return params._layers
    return _layer_views(as_tree(params), cfg)


def kv_len(cache: dict) -> int | None:
    """The attention caches' length (every K/V and MLA latent leaf is
    (layers, batch, kv_len, ...)); None for a cache without attention."""
    for path, t in tree_leaves(cache):
        if path.rsplit(".", 1)[-1] in ("k", "c_kv"):
            return t.shape[2]
    return None


# ----------------------------------------------------------------- forward ----
def embed_scale(cfg: ModelConfig, dtype: torch.dtype) -> float:
    """gemma's embedding scale sqrt(d_model), rounded to the activations'
    dtype first as the reference rounds it (45.25 in bf16 at d = 2048, not
    45.2548): exact as a Python float, so the product rounds once."""
    return float(torch.tensor(cfg.d_model ** 0.5, dtype=dtype))


def _embed_prefix(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  patches: torch.Tensor | None):
    """(embedded inputs (B, S, d), prefix length): the tokens' embeddings;
    for the vlm family scaled by ``embed_scale`` and preceded by the
    patches' projection, [vis | text], the patches being the prefix."""
    x = embed(params["embed"], tokens, cfg)
    if cfg.family != "vlm":
        return x, 0
    if patches is None:
        raise ValueError("the vlm family needs a `patches` input (stub patch "
                         "embeddings (B, n_patches, vision_width))")
    x = x * embed_scale(cfg, x.dtype)
    vis = patches.to(cfg.cdtype) @ params["vision_proj"].to(cfg.cdtype)
    return torch.cat([vis, x], dim=1), patches.shape[1]


def lm_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
              patches: torch.Tensor | None = None) -> torch.Tensor:
    """Tokens (B, S) (after the vlm family's ``patches`` (B, n_patches,
    vision_width)) -> final-norm hidden states (B, [n_patches +] S, d)."""
    (stages, shared), params = _layers(params, cfg), as_tree(params)
    x, prefix_len = _embed_prefix(params, cfg, tokens, patches)
    x = _edge(x)
    kw = {"prefix_len": prefix_len} if prefix_len else {}
    for (kind, _), stage in zip(layer_plan(cfg), stages):
        if kind == "zamba_seg":
            x = hybrid_mod.zamba_seg_scan(stage, cfg, x, shared, _maybe_remat)
            continue
        fwd = _maybe_remat(_BLOCKS[kind]["fwd"], cfg)
        for lp in stage:
            x = fwd(lp, cfg, x, **kw)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: ``tokens`` (B, S), ``labels`` (B, S) [, ``patches`` (B, P, W),
    ``mask`` (B, S)] -> the scalar float32 loss; the vlm family's over the
    text tail only (its hidden states after the P patch positions)."""
    patches = batch.get("patches")
    hidden = lm_hidden(params, cfg, batch["tokens"], patches)
    if cfg.family == "vlm":
        hidden = hidden[:, patches.shape[1]:, :]
    return chunked_ce_loss(as_tree(params)["embed"], cfg, hidden,
                           batch["labels"], batch.get("mask"))


def _padded_to_max_len(cfg: ModelConfig) -> bool:
    """Whether the family's prefill pads attention caches to ``max_len``."""
    return any(kind in ("dense", "moe", "zamba_seg")
               for kind, _ in layer_plan(cfg))


def lm_prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
               patches: torch.Tensor | None = None):
    """Process a prompt (after the vlm family's ``patches``); return
    (last-position logits (B, 1, V), cache). A prefill longer than an
    attention cache's ``max_len`` raises ``ValueError`` before any work
    (``check_fits``)."""
    if _padded_to_max_len(cfg):
        check_fits(tokens.shape[1] + (patches.shape[1] if cfg.family == "vlm"
                                      and patches is not None else 0),
                   max_len)
    (stages, shared), params = _layers(params, cfg), as_tree(params)
    x, prefix_len = _embed_prefix(params, cfg, tokens, patches)
    x = _edge(x)
    kw = {"prefix_len": prefix_len} if prefix_len else {}
    caches = {}
    for i, ((kind, _), stage) in enumerate(zip(layer_plan(cfg), stages)):
        if kind == "zamba_seg":
            x, caches[f"stage_{i}"] = hybrid_mod.zamba_seg_prefill_scan(
                stage, cfg, x, shared, max_len)
            continue
        pf = _BLOCKS[kind]["prefill"]
        buf = None
        for j, lp in enumerate(stage):
            x, c = pf(lp, cfg, x, max_len, **kw)
            buf = store_layer(buf, j, len(stage), c)
        caches[f"stage_{i}"] = buf
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h[:, -1:, :], cfg), caches


def lm_decode(params, cfg: ModelConfig, token: torch.Tensor, pos, cache: dict):
    """One decode step. token: (B, 1) ids; pos: a Python int (every row at
    the same position) or a (B,) tensor. The cache is written in place and
    returned with the logits (B, 1, V). Attention positions are
    range-checked once for the whole step (one host read for a tensor), not
    per layer; the recurrent blocks ignore ``pos``, as in the reference.
    The vlm family's token embeddings are scaled as in its prefill."""
    (stages, shared), params = _layers(params, cfg), as_tree(params)
    Smax = kv_len(cache)
    if Smax is not None:
        attn.check_positions(pos, Smax)
    x = embed(params["embed"], token, cfg)
    if cfg.family == "vlm":
        x = x * embed_scale(cfg, x.dtype)
    for i, ((kind, _), stage) in enumerate(zip(layer_plan(cfg), stages)):
        sc = cache[f"stage_{i}"]
        if kind == "zamba_seg":
            x, _ = hybrid_mod.zamba_seg_decode_scan(stage, cfg, x, sc, shared,
                                                    pos)
            continue
        dec = _BLOCKS[kind]["decode"]
        for layer, lp in enumerate(stage):
            lc = tree_map(lambda t, layer=layer: t[layer], sc)
            x, _ = dec(lp, cfg, x, lc, pos)
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h, cfg), cache
