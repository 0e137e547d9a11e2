"""Model configuration and parameter-tree machinery (port of
``repro.models.common``).

Parameters are nested dicts of tensors, keyed as in the JAX package, with a
parallel tree of ``Spec`` leaves (shape, logical axes, init scale). The
config crosses between the two packages through ``dataclasses.asdict``: it
has the same fields and defaults.

``init_params`` draws from an explicit ``torch.Generator`` seeded by the
caller. It uses the JAX package's distributions and scales (truncated
normals on [-2, 2] times the spec's scale, ones for a 1-D scale-1 leaf,
zeros for biases) but not its bits: parity tests carry the JAX package's parameters
across with ``repro_torch.convert.params_from_numpy`` instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | encdec | xlstm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab: int = 512
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    n_dense_layers: int = 0
    norm_topk_prob: bool = False
    moe_group_size: int = 4096
    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (Mamba-2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (zamba2) ---
    attn_every: int = 6
    n_shared_blocks: int = 2
    # --- xLSTM ---
    slstm_every: int = 8
    mlstm_proj_factor: float = 2.0
    # --- vlm ---
    n_patches: int = 0
    vision_width: int = 0
    prefix_lm: bool = False
    # --- encdec ---
    n_enc_layers: int = 0
    # --- numerics / structure ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"
    scan_layers: bool = True
    logits_chunk: int = 0
    use_flash: bool = False        # the flash-attention kernel in prefill
    attn_chunk: int = 0            # 0 -> sdpa; else q-chunked sdpa_chunked
    mlstm_chunk: int = 1024
    unroll_loops: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------------ param trees ----
@dataclasses.dataclass(frozen=True)
class Spec:
    """Declarative leaf: shape + logical sharding axes (+ init scale)."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    scale: float = 0.02
    dtype: Any = None  # defaults to cfg param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(dotted path, leaf) pairs of a nested dict, in sorted key order (the
    order ``jax.tree`` flattens a dict in)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(tree_leaves(v, path + "."))
        else:
            out.append((path, v))
    return out


def tree_set(tree: dict, path: str, value) -> None:
    """Set the leaf at a dotted path, making the dicts on the way."""
    *parents, name = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[name] = value


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def store_layer(buf: dict | None, i: int, n: int, tree: dict) -> dict:
    """Copy layer i's tree of tensors into ``buf``, the stack of n such
    trees along a new leading axis (made from the first one to arrive when
    ``buf`` is None), and return ``buf``: the layer-stacked caches of the
    JAX package's scans, without holding every layer's tree twice. A
    DTensor layer's stack keeps its split (``_stack_buffer``)."""
    if buf is None:
        buf = tree_map(lambda t: _stack_buffer(t, n), tree)
    for k, v in tree.items():
        if isinstance(v, dict):
            store_layer(buf[k], i, n, v)
        else:
            buf[k][i].copy_(v)
    return buf


def _stack_buffer(t: torch.Tensor, n: int) -> torch.Tensor:
    """An empty (n, *t.shape) stack for n tensors like ``t``. For a DTensor
    each rank allocates only its block, split where ``t`` is evenly split,
    one axis further in (DTensor's ``new_empty`` would make the whole
    stack on every rank)."""
    if not isinstance(t, DTensor):
        return t.new_empty((n, *t.shape))
    mesh = t.device_mesh
    shape = [n, *t.shape]
    pl = []
    for i, p in enumerate(t.placements):
        if type(p) is Shard and shape[p.dim + 1] % mesh.size(i) == 0:
            shape[p.dim + 1] //= mesh.size(i)
            pl.append(Shard(p.dim + 1))
        else:
            pl.append(Replicate())
    local = t.to_local().new_empty(shape)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=(n, *t.shape),
                              stride=torch.empty((n, *t.shape),
                                                 device="meta").stride())


def unstack(tree: dict, n: int) -> list[dict]:
    """The inverse view: n trees, the i-th indexing every leaf at i (views,
    no copies). One ``unbind`` a leaf: under autograd its backward stacks
    the n layers' gradients in one op, where n ``t[i]`` views would each
    scatter into a zero tensor of the whole stack."""
    cols = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda c, i=i: c[i], cols) for i in range(n)]


def tree_specs(spec_tree) -> dict:
    """The abstract parameter tree: each leaf an empty tensor of the spec's
    shape and dtype on the ``meta`` device (no allocation), the twin of the
    reference's ``ShapeDtypeStruct`` tree."""
    return tree_map(lambda s: torch.empty(
        s.shape, dtype=torch_dtype(s.dtype or "float32"), device="meta"),
        spec_tree)


def tree_axes(spec_tree) -> dict:
    """The parallel tree of logical-axis tuples."""
    return tree_map(lambda s: s.axes, spec_tree)


def n_params(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves(spec_tree))


def spec_with_dtype(spec_tree, dtype) -> Any:
    return tree_map(
        lambda s: dataclasses.replace(s, dtype=dtype) if s.dtype is None else s,
        spec_tree)


def init_tree(spec_tree, generator: torch.Generator, device) -> dict:
    """Materialize parameters: truncated normal on [-2, 2], drawn in float32,
    cast to the spec's dtype, times the scale; ones for 1-D scale-1 leaves
    (the final norm; the layer-stacked (L, d) norm weights are drawn like
    any leaf, as the JAX package's ``init_tree`` draws them), zeros for
    scale-0 leaves (biases)."""
    def leaf(s: Spec):
        dt = torch_dtype(s.dtype or "float32")
        if s.scale == 0.0:
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.scale == 1.0 and len(s.shape) == 1:
            return torch.ones(s.shape, dtype=dt, device=device)
        t = torch.empty(s.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return s.scale * t.to(dt)
    out: dict = {}
    for path, s in tree_leaves(spec_tree):
        tree_set(out, path, leaf(s))
    return out


# ---------------------------------------------------------------- helpers ----
def dense_spec(d_in: int, d_out: int, axes=("embed", "mlp"), scale=None) -> Spec:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return Spec((d_in, d_out), axes, scale)


def norm_spec(d: int, axis: str | None = None) -> Spec:
    return Spec((d,), (axis,), scale=1.0)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu_tanh, "gelu_mlp": _gelu_tanh,
            "relu": F.relu}[name]


def _map_any(fn, tree):
    """``fn`` over the tensor leaves of nested dicts, lists and tuples
    (``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_any(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_any(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    if isinstance(tree, dict):
        tree = next(iter(tree.values()))
        return _first_leaf(tree)
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def _stack(ys: list):
    if isinstance(ys[0], dict):
        return {k: _stack([y[k] for y in ys]) for k in ys[0]}
    if isinstance(ys[0], (list, tuple)):
        return type(ys[0])(_stack(list(c)) for c in zip(*ys))
    return torch.stack(ys)


def maybe_scan(cfg: ModelConfig, body, init, xs, length: int | None = None):
    """The reference's ``lax.scan`` (or its unrolled loop) over STRUCTURAL
    loops — layer stacks, CE chunks, microbatches: a Python loop, ``carry,
    y = body(carry, x_i)`` with ``x_i`` every leaf of ``xs`` (nested dicts,
    lists, tuples) at i; returns ``(carry, ys)``, the ``y``s stacked along a
    new leading axis, or ``None`` when every ``y`` is ``None``. ``cfg`` is
    taken for the reference's signature: both of its modes are this loop."""
    n = length if xs is None else _first_leaf(xs).shape[0]
    carry, ys = init, []
    for i in range(n):
        xi = None if xs is None else _map_any(lambda a, i=i: a[i], xs)
        carry, y = body(carry, xi)
        ys.append(y)
    if all(y is None for y in ys):
        return carry, None
    return carry, _stack(ys)
