"""Checkpoint store (port of ``repro.checkpoint.store``), partial.

Ported: ``_flatten`` and ``_unflatten_like``, the path vocabulary that the
serving snapshots (``repro_torch.serve.resilience``) share with the JAX
package. A leaf's path is its keys joined by ``"/"``: a ``NamedTuple``
field is ``.name``, a dict key its ``str``, a list or tuple index its
number — the strings ``jax.tree_util``'s key paths give, so a tree flattens
to the same keys in both packages. Dict keys are visited in sorted order
and ``None`` is an empty subtree, as in ``jax.tree_util``.

Not ported yet: the on-disk store (``save``, ``restore``, ``latest_step``,
``step_dir``, ``AsyncSaver``), ROADMAP.md item A13. Those names exist and
refuse, naming the item.
"""

from __future__ import annotations

from typing import Any

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """(path entry, child) pairs of an inner node; None for a leaf."""
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _walk(node, prefix: tuple[str, ...], out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((_SEP.join(prefix), node))
        return
    for entry, child in kids:
        _walk(child, prefix + (entry,), out)


def _flatten(tree: Any) -> dict[str, Any]:
    """``{path: leaf}`` over NamedTuples, dicts, lists and tuples."""
    out: list = []
    _walk(tree, (), out)
    return dict(out)


def _rebuild(node, prefix: tuple[str, ...], flat: dict[str, Any]):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        key = _SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing array {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(
                f"{key}: checkpoint shape {tuple(arr.shape)} != expected "
                f"{tuple(node.shape)}")
        return arr
    vals = [_rebuild(c, prefix + (e,), flat) for e, c in kids]
    if _is_namedtuple(node):
        return type(node)(*vals)
    if isinstance(node, dict):
        return dict(zip(sorted(node), vals))
    return type(node)(vals)


def _unflatten_like(template: Any, flat: dict[str, Any]) -> Any:
    """Rebuild ``template``'s structure from ``flat``: every template leaf
    (anything with a ``.shape``) is replaced by the array at its path,
    whose shape must match."""
    return _rebuild(template, (), flat)


def _refuse(name: str):
    raise NotImplementedError(
        f"{name}: the on-disk checkpoint store is not ported yet "
        "(ROADMAP.md item A13)")


def step_dir(base: str, step: int) -> str:
    _refuse("step_dir")


def save(base: str, step: int, tree: Any, extra: dict | None = None) -> str:
    _refuse("save")


def latest_step(base: str) -> int | None:
    _refuse("latest_step")


def restore(base: str, step: int, template: Any, shardings: Any = None):
    _refuse("restore")


class AsyncSaver:
    def __init__(self, *args, **kw):
        _refuse("AsyncSaver")
