"""Logical-axis → mesh-axis rules and sharding helpers.

Port of ``repro.sharding.rules``, same names, logic and return shapes.
Every parameter/activation carries logical axis names; these rules map them
onto the production mesh axes ("pod", "data", "model") — FSDP over
``data`` × tensor parallel over ``model`` × pure data parallel over
``pod`` — and the root-parallel forest's member axis onto the 1-D
ensemble mesh's ``"ens"``.

A ``PartitionSpec`` here is ``P``, a tuple of entries (a mesh axis name, a
tuple of them, or None), and ``NamedSharding`` pairs it with a
``launch.mesh.Mesh``: records that say where each dimension goes. The
forest path reads them (``core.root_parallel.ensemble_spec``) and splits
its members itself.

The LM meshes are ``torch.distributed`` ``DeviceMesh``es
(``launch.mesh.make_production_mesh``), and an LM tensor under one is a
DTensor. ``placements_for`` maps a spec onto DTensor placements (a
dimension over several mesh axes is ``Shard(dim)`` on each, major to
minor, as JAX splits it), ``distribute_to`` places a ``meta`` or real
tensor (each rank keeps only its own block), and ``shard`` — the
reference's ``with_sharding_constraint`` — redistributes a DTensor to its
annotation's placements. Outside any mesh ``shard`` returns its argument
itself, with no op: every single-card path is untouched.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple

import torch

from repro_torch.launch.mesh import axis_names, mesh_dims

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),   # activation batch dim
    "seq": None,
    "act_seq": "model",         # Megatron-style sequence parallelism at block edges
    "kv_len": "data",           # long-context decode: shard cache length
    "embed": "data",            # FSDP shard of the d_model weight axis
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "expert_group": "data",     # MoE token groups (expert-compute phase)
    "expert_group_all": ("data", "model"),  # groups own whole chips outside
                                            # the expert phase (dispatch/combine)
    "ssm_heads": "model",
    "layers": None,
    "conv": None,
    "lora": None,
    # root-parallel MCTS: the forest's leading member axis splits over the
    # 1-D ensemble mesh (launch.mesh.make_ensemble_mesh); on LM meshes
    # (no "ens" axis) logical_to_spec drops it, so the rule is inert there
    "ensemble": "ens",
}


class P(tuple):
    """A partition spec: one entry per dimension (a mesh axis, a tuple of
    mesh axes, or None for a dimension that is not split)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """Where each dimension of an array goes on ``mesh``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        """The spec as DTensor placements on a ``DeviceMesh``."""
        return placements_for(self.mesh, self.spec)


_state = threading.local()


def current_rules() -> dict[str, Any]:
    return getattr(_state, "rules", DEFAULT_RULES)


def current_mesh() -> Any:
    return getattr(_state, "mesh", None)


_registered = []


def _register_strategies() -> None:
    """Sharding strategies DTensor lacks for ops the models run sharded:
    ``log_sigmoid_backward`` (the mLSTM gates' backward) is pointwise in its
    three tensors. Registered once, when an LM mesh is first used."""
    if _registered:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_backward.default)
    def _pointwise3(grad_out, x, buffer):
        # (the arguments are DTensor specs; an empty buffer stays whole)
        whole = tuple(buffer.shape) != tuple(x.shape)
        out = [([Replicate()], [Replicate()] * 3)]
        for d in range(len(x.shape)):
            out.append(([Shard(d)], [Shard(d), Shard(d),
                                     Replicate() if whole else Shard(d)]))
        return out

    _registered.append(True)


@contextlib.contextmanager
def use_rules(rules: dict[str, Any], mesh: Any = None):
    if is_lm_mesh(mesh):
        _register_strategies()
    old_r = getattr(_state, "rules", None)
    old_m = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        if old_r is None:
            del _state.rules
        else:
            _state.rules = old_r
        if old_m is None:
            if hasattr(_state, "mesh"):
                del _state.mesh
        else:
            _state.mesh = old_m


def under_current_rules(fn):
    """``fn`` bound to the rules and mesh current now: a recomputation in
    the backward (``torch.utils.checkpoint``) may run on the autograd
    engine's device thread, which does not see this thread's
    ``use_rules``. ``fn`` itself when none is set."""
    rules, mesh = getattr(_state, "rules", None), current_mesh()
    if rules is None and mesh is None:
        return fn

    def bound(*args, **kw):
        with use_rules(rules or DEFAULT_RULES, mesh):
            return fn(*args, **kw)
    return bound


def _mesh_axes(mesh: Any):
    if mesh is None:
        return None
    return set(axis_names(mesh))


def logical_to_spec(axes: tuple[str | None, ...],
                    rules: dict[str, Any] | None = None,
                    mesh: Any = None) -> P:
    """Map logical axes to a PartitionSpec, dropping mesh axes not present
    (and any mesh axis an earlier dimension already took)."""
    rules = rules or current_rules()
    mesh = mesh or current_mesh()
    names = _mesh_axes(mesh)
    out = []
    used: set[str] = set()
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        cand = m if isinstance(m, tuple) else (m,)
        keep = tuple(c for c in cand
                     if (names is None or c in names) and c not in used)
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(keep)
    return P(*out)


def _divisible_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop mesh axes from dims they do not divide (e.g. S=1 over model=16)."""
    sizes = mesh_dims(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        cand = entry if isinstance(entry, tuple) else (entry,)
        keep, prod = [], 1
        for c in cand:
            if dim % (prod * sizes[c]) == 0:
                keep.append(c)
                prod *= sizes[c]
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


def is_lm_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (an LM mesh: its tensors are
    DTensors), not a ``launch.mesh.Mesh`` of devices."""
    return mesh is not None and not hasattr(mesh, "devices")


def placements_for(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dimension,
    ``Shard(d)`` where tensor dimension d goes, ``Replicate()`` elsewhere.
    A dimension over several mesh axes is split major to minor in the
    order they are named, which must be the mesh's own order (as every
    rule's is), so that DTensor's default shard order is JAX's."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a)
               for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dimension {dim} names mesh axes "
                             f"out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def spec_for(mesh, axes: tuple[str | None, ...], shape: tuple[int, ...],
             rules: dict[str, Any] | None = None) -> P:
    """The divisibility-aware spec of a tensor of ``shape`` with logical
    ``axes`` on ``mesh``."""
    return _divisible_spec(logical_to_spec(axes, rules, mesh), tuple(shape),
                           mesh)


def local_slices(mesh, spec: P, shape: tuple[int, ...],
                 coord: tuple[int, ...]) -> tuple[slice, ...]:
    """The block of a ``shape`` tensor that the rank at mesh coordinate
    ``coord`` holds under ``spec`` (every split divides: ``spec`` is a
    divisible spec): the index ranges of JAX's ``devices_indices_map``."""
    names, sizes = axis_names(mesh), mesh_dims(mesh)
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        cand = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx, parts = 0, 1
        for a in cand:                       # major to minor
            idx = idx * sizes[a] + coord[names.index(a)]
            parts *= sizes[a]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def distribute_to(mesh, t, axes: tuple[str | None, ...],
                  rules: dict[str, Any] | None = None, init=None):
    """``t`` (a ``meta`` or real tensor of the global shape) as a DTensor
    on ``mesh`` under its logical ``axes``: this rank keeps only its own
    block — of ``meta`` for a ``meta`` tensor, a copy of its slice of a
    real one — or, with ``init(local_shape, dtype)``, the block that
    ``init`` makes (the whole tensor is never built). A leaf that requires
    grad stays a leaf that requires grad."""
    return place(NamedSharding(mesh, spec_for(mesh, axes, tuple(t.shape),
                                              rules)), t, init)


def place(sharding: NamedSharding, t, init=None):
    """``t`` as a DTensor on ``sharding.mesh`` under ``sharding.spec``,
    which must divide ``t``'s shape (``distribute_to``'s contract for the
    rest: this rank keeps only its own block)."""
    from torch.distributed.tensor import DTensor

    mesh, spec = sharding
    sl = local_slices(mesh, spec, tuple(t.shape), tuple(mesh.get_coordinate()))
    local_shape = tuple(s.stop - s.start for s in sl)
    if init is not None:
        local = init(local_shape, t.dtype)
    elif t.is_meta:
        local = torch.empty(local_shape, dtype=t.dtype, device="meta")
    else:
        local = t.detach()[sl].clone()
    out = DTensor.from_local(local, mesh, placements_for(mesh, spec),
                             run_check=False, shape=t.shape,
                             stride=t.stride())
    return out.requires_grad_() if t.requires_grad else out


def shard(x, axes: tuple[str | None, ...],
          rules: dict[str, Any] | None = None):
    """A sharding constraint by logical axes (the reference's
    ``with_sharding_constraint``). Outside a mesh, and inside the ensemble
    mesh where no LM axis maps, ``x`` itself: no op. Inside an LM mesh
    ``x`` must be a DTensor, redistributed to the divisible spec's
    placements (a no-op when it has them); a plain tensor there raises,
    since it would mean an input or a region that lost its sharding."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if not is_lm_mesh(mesh):
        spec = _divisible_spec(logical_to_spec(axes, rules, mesh),
                               tuple(x.shape), mesh)
        if any(e is not None for e in spec) or set(mesh.axis_names) - {"ens"}:
            raise TypeError(
                f"shard{tuple(axes)} on the device list mesh "
                f"{mesh_dims(mesh)}: an LM mesh is a DeviceMesh "
                "(launch.mesh.make_production_mesh)")
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(
            f"shard{tuple(axes)}: a plain {type(x).__name__} of shape "
            f"{tuple(x.shape)} inside the LM mesh {mesh_dims(mesh)}; every "
            "activation of a sharded step is a DTensor (inputs from "
            "launch.inputs.input_specs(mesh=) or distribute_to)")
    pl = placements_for(mesh, spec_for(mesh, axes, tuple(x.shape), rules))
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def named_sharding_for(mesh, axes: tuple[str | None, ...],
                       shape: tuple[int, ...],
                       rules: dict[str, Any] | None = None) -> NamedSharding:
    """Divisibility-aware NamedSharding for a concrete global shape."""
    spec = _divisible_spec(logical_to_spec(axes, rules, mesh), shape, mesh)
    return NamedSharding(mesh, spec)


def named_sharding(mesh, axes: tuple[str | None, ...],
                   rules: dict[str, Any] | None = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(axes, rules, mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, str) or e is None
                                        for e in x)


def tree_shardings(mesh, axes_tree, rules: dict[str, Any] | None = None):
    """Map a tree (dicts, lists, tuples, NamedTuples) of logical-axis tuples
    to NamedShardings."""
    def walk(node):
        if _is_axes(node):
            return named_sharding(mesh, node, rules)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(axes_tree)


def mesh_coord(axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) of a dimension
    split over the current LM mesh's ``axes``, major to minor."""
    mesh = current_mesh()
    names, sizes = axis_names(mesh), mesh_dims(mesh)
    coord = mesh.get_coordinate()
    idx, parts = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[names.index(a)]
        parts *= sizes[a]
    return idx, parts


def sharded_axes(x, dim: int) -> tuple[str, ...]:
    """The mesh axes a DTensor's dimension ``dim`` is split over, major to
    minor (empty for a whole dimension)."""
    mesh = current_mesh()
    return tuple(n for n, p in zip(axis_names(mesh), x.placements)
                 if p.is_shard(dim))


def spec_axes(axes: tuple, shape: tuple, dim: int) -> tuple[str, ...]:
    """The current LM mesh's axes that dimension ``dim`` of a tensor of
    ``shape`` with logical ``axes`` is split over by its divisible spec,
    major to minor (empty when whole)."""
    ax = spec_for(current_mesh(), axes, shape)[dim]
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def local_region(fn, args, in_axes, out_axes):
    """``fn`` run on this rank's local shards (DTensor's ``local_map``)
    inside the current LM mesh: each tensor of ``args`` is first
    redistributed to the placements of its logical axes in ``in_axes``
    (a plain tensor — the same on every rank — is taken as replicated;
    ``None`` passes a non-tensor through), and each output, given as
    ``(logical axes, global shape)`` in ``out_axes`` (a list for several),
    is wrapped with its placements. Where a tuple of DTensor placements
    stands in place of logical axes, it is taken as it is. ``fn`` sees
    ``torch.Tensor``s, and the region's collectives are its own
    (``all_reduce``)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = current_mesh()
    rep = (Replicate(),) * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep, run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            and ax is not None else a for a, ax in zip(args, in_axes)]
    in_pl = tuple(None if ax is None else _as_placements(ax, a.shape)
                  for a, ax in zip(args, in_axes))
    many = isinstance(out_axes, list)
    outs = out_axes if many else [out_axes]
    # local_map reads a list as one output's placements, a tuple as several
    out_pl = [None if o is None else list(_as_placements(*o)) for o in outs]

    def body(*xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                    and x.requires_grad else x for x in xs))

    f = local_map(body, out_placements=tuple(out_pl) if many else out_pl[0],
                  in_placements=in_pl, in_grad_placements=grad_placements(
                      in_pl), device_mesh=mesh, redistribute_inputs=True)
    return f(*args)


def grad_placements(in_pl) -> tuple:
    """The placements of a region's input gradients: as the inputs',
    except that an input whole on a mesh axis that splits another input
    gets a partial sum there (each rank's gradient covers only its own
    part of the work)."""
    from torch.distributed.tensor import Partial

    split = {i for pl in in_pl if pl is not None
             for i, p in enumerate(pl) if p.is_shard()}
    return tuple(None if pl is None else tuple(
        Partial() if i in split and p.is_replicate() else p
        for i, p in enumerate(pl)) for pl in in_pl)


def _as_placements(axes, shape) -> tuple:
    from torch.distributed.tensor import Placement

    if axes and isinstance(axes[0], Placement):
        return tuple(axes)
    mesh = current_mesh()
    return placements_for(mesh, spec_for(mesh, axes, shape))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves a region contiguous: DTensor
    views a gradient by its global strides, which a region's permuted local
    gradient would not have."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _AllReduce(torch.autograd.Function):
    """An all-reduce inside a region. Its gradient is the result's own
    (``grad="same"``) where every rank then uses the result alike (a
    region's replicated output), or the result's gradient summed over the
    axis (``grad="sum"``) where each rank uses it on its own share of the
    work (a softmax's denominator scaling the rank's own slice)."""

    @staticmethod
    def forward(ctx, x, op: str, axis: str, grad: str):
        # the mesh kept for the backward, which may run on another thread
        ctx.mesh, ctx.axis, ctx.grad = current_mesh(), axis, grad
        return _reduce(x, op, ctx.mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = _reduce(g.contiguous(), "sum", ctx.mesh, ctx.axis)
        return g, None, None, None


def _reduce(x, op: str, mesh, axis: str):
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_reduce(x, op, (mesh, axis_names(mesh).index(axis)))
    return out.wait() if hasattr(out, "wait") else out


def all_reduce(x, op: str, axes: tuple[str, ...], grad: str = "same"):
    """``x`` all-reduced (``"sum"`` or ``"max"``) over the current LM
    mesh's ``axes`` inside a region; its gradient as ``_AllReduce``'s
    ``grad`` says. With no axes, ``x`` itself."""
    if grad not in ("same", "sum"):
        raise ValueError(f"all_reduce: grad is 'same' or 'sum', got {grad!r}")
    for a in axes:
        x = _AllReduce.apply(x, op, a, grad)
    return x


def heads_splittable(y, h: int):
    """A DTensor ``y`` with its last axis (h*k, flattened from (h, k))
    split only over mesh axes whose product divides ``h`` (the rest
    gathered), so that a reshape to (h, k) keeps the split on h."""
    from torch.distributed.tensor import Replicate

    last = y.dim() - 1
    sizes = y.device_mesh.shape
    parts, pl = 1, list(y.placements)
    for i, p in enumerate(pl):
        if p.is_shard(last):
            if h % (parts * sizes[i]):
                pl[i] = Replicate()
            else:
                parts *= sizes[i]
    if pl == list(y.placements):
        return y
    return y.redistribute(y.device_mesh, pl)


class _SplittableGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, h: int):
        ctx.h = h
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return heads_splittable(g, ctx.h), None


def splittable_grad(y, h: int):
    """The identity on a DTensor whose last axis (h*k) was flattened from
    (h, k): its gradient is made ``heads_splittable`` before the flatten's
    backward unflattens it."""
    return _SplittableGrad.apply(y, h)


def fold_rows(x):
    """A DTensor ``x`` with every dimension between the first and the last
    whole (gathered where split), so that a matmul may fold them into its
    rows: a view merges a split dimension only as the first of the merged
    group, and DTensor (as of torch 2.11) refuses the fold of a sequence
    split by ``act_seq``, where the reference's partitioner regathers it
    (torch 2.13's matmul gathers it too, inside). Anything else is
    returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or x.dim() < 3:
        return x
    middle = range(1, x.dim() - 1)
    pl = [Replicate() if any(p.is_shard(d) for d in middle) else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


class _FoldGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return fold_rows(g)


def fold_matmul(x, w):
    """``x @ w`` (x of rank 3 or more, w of rank 2) with ``x``'s middle
    dimensions whole (``fold_rows``), and the product's gradient made whole
    there too before the matmul's backward folds it: the gradient arriving
    from a block edge's ``act_seq`` annotation is split over the
    sequence."""
    from torch.distributed.tensor import DTensor

    y = fold_rows(x) @ w
    return _FoldGrad.apply(y) if isinstance(y, DTensor) else y


def whole_dims(x, dims: tuple[int, ...]):
    """A DTensor ``x`` with the given dimensions whole on every rank
    (gathered where they are split) and no partial sum pending (reduced):
    where the model reshapes an axis that an annotation, or DTensor's own
    choice of where to reduce, split — as the reference's partitioner
    regathers it."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if p.is_partial() or any(p.is_shard(d) for d in dims)
          else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)
