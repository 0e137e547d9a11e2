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
its members itself. Placing an LM tensor under a sharding constraint
(``shard`` inside a mesh with LM axes) is the sharded analysis, ROADMAP.md
A14b, and refuses.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple

from repro_torch.launch.mesh import A14B, Mesh, mesh_dims

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

    mesh: Mesh
    spec: P


_state = threading.local()


def current_rules() -> dict[str, Any]:
    return getattr(_state, "rules", DEFAULT_RULES)


def current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: dict[str, Any], mesh: Mesh | None = None):
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


def _mesh_axes(mesh: Mesh | None):
    if mesh is None:
        return None
    return set(mesh.axis_names)


def logical_to_spec(axes: tuple[str | None, ...],
                    rules: dict[str, Any] | None = None,
                    mesh: Mesh | None = None) -> P:
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


def _divisible_spec(spec: P, shape: tuple[int, ...], mesh: Mesh) -> P:
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


def shard(x, axes: tuple[str | None, ...],
          rules: dict[str, Any] | None = None):
    """A sharding constraint by logical axes: a no-op outside a mesh (and
    inside the ensemble mesh, where no LM axis maps). Placing ``x`` over a
    mesh's axes is A14b's and refuses."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = _divisible_spec(logical_to_spec(axes, rules, mesh),
                           tuple(x.shape), mesh)
    if any(e is not None for e in spec) or set(mesh.axis_names) - {"ens"}:
        raise NotImplementedError(
            f"shard{tuple(axes)} on mesh {mesh_dims(mesh)}: {A14B}")
    return x


def named_sharding_for(mesh: Mesh, axes: tuple[str | None, ...],
                       shape: tuple[int, ...],
                       rules: dict[str, Any] | None = None) -> NamedSharding:
    """Divisibility-aware NamedSharding for a concrete global shape."""
    spec = _divisible_spec(logical_to_spec(axes, rules, mesh), shape, mesh)
    return NamedSharding(mesh, spec)


def named_sharding(mesh: Mesh, axes: tuple[str | None, ...],
                   rules: dict[str, Any] | None = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(axes, rules, mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, str) or e is None
                                        for e in x)


def tree_shardings(mesh: Mesh, axes_tree, rules: dict[str, Any] | None = None):
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
