"""Fault-tolerant checkpoint store: atomic, async (port of
``repro.checkpoint.store``).

Layout, the reference's::

    <dir>/step_000000123/
        manifest.json      # step, every array's shape and dtype, extra
        arrays.npz         # flattened path -> array
    <dir>/LATEST           # atomically-renamed pointer file

A leaf's path is its keys joined by ``"/"``: a ``NamedTuple`` field is
``.name``, a dict key its ``str``, a list or tuple index its number, a
``TransformerLM`` its parameter tree — the strings ``jax.tree_util``'s key
paths give, so a tree flattens to the same keys in both packages (dict keys
in sorted order, ``None`` an empty subtree) and a checkpoint written by
either package restores in the other. npz holds no bfloat16: such leaves
are stored as float32, and ``restore`` casts each array to its template
leaf's dtype.

- **atomic**: a step is written under a ``.tmp`` name and renamed into
  place; ``LATEST`` is replaced last, so a crash mid-save never corrupts
  the restore path (``latest_step`` also skips partial directories).
- **async**: ``AsyncSaver.save`` copies the tree to host memory at once
  and writes it to disk on a background thread, overlapping the I/O with
  the next training steps; ``wait()`` joins and re-raises its error.

- **elastic**: arrays are saved as global values. Saving a tree of
  DTensors (a state on a mesh) gathers each one whole on every rank
  (``full_tensor()``, in the tree's order, so that every rank issues the
  same collectives), only rank 0 of the group writes, and a barrier keeps
  the other ranks from reading ``LATEST`` before it is written.
  ``restore(shardings=)`` reads each whole array on every rank and keeps
  the rank's block (``sharding.rules.place``): a checkpoint written on one
  card restores onto a mesh, and one written on a mesh onto one card.

The flatten helpers are shared with the serving snapshots
(``repro_torch.serve.resilience``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import NamedSharding, place

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _as_tree(node):
    """A ``TransformerLM`` (anything with a ``tree()``) is its tree."""
    return node.tree() if callable(getattr(node, "tree", None)) else node


def _children(node) -> list[tuple[str, Any]] | None:
    """(path entry, child) pairs of an inner node; None for a leaf."""
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _walk(node, prefix: tuple[str, ...], out: list, leaf_type) -> None:
    if node is None:
        return
    node = _as_tree(node)
    kids = None if isinstance(node, leaf_type) else _children(node)
    if kids is None:
        out.append((_SEP.join(prefix), node))
        return
    for entry, child in kids:
        _walk(child, prefix + (entry,), out, leaf_type)


def _flatten(tree: Any, leaf_type=()) -> dict[str, Any]:
    """``{path: leaf}`` over NamedTuples, dicts, lists and tuples (an
    instance of ``leaf_type`` is a leaf)."""
    out: list = []
    _walk(tree, (), out, leaf_type)
    return dict(out)


def _gathered(tree: Any) -> tuple[dict[str, Any], bool]:
    """(``{path: leaf}`` with every DTensor leaf gathered whole, whether
    there was one). Every rank gathers, in path order."""
    flat = _flatten(tree)
    sharded = False
    for k, v in flat.items():
        if isinstance(v, DTensor):
            flat[k] = v.detach().full_tensor()
            sharded = True
    return flat, sharded


def _writes() -> bool:
    """Whether this process writes a sharded tree: rank 0 of the group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _rebuild(node, prefix: tuple[str, ...], flat: dict[str, Any]):
    if node is None:
        return None
    node = _as_tree(node)
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
    whose shape must match (a ``TransformerLM`` template gives its tree,
    a dict)."""
    return _rebuild(template, (), flat)


def step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


def _to_numpy(v) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 (which npz cannot hold) and
    other non-numpy floats as float32."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.to(torch.float32)
        return v.cpu().numpy()
    a = np.asarray(v)
    if a.dtype.kind == "V" or str(a.dtype) in ("bfloat16", "float8_e4m3fn",
                                               "float8_e5m2"):
        a = a.astype(np.float32)
    return a


def save(base: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays);
    DTensor leaves gathered, written by rank 0 (module docstring)."""
    flat, sharded = _gathered(tree)
    final = (_write(base, step, flat, extra) if _writes() or not sharded
             else step_dir(base, step))
    if sharded:
        _barrier()
    return final


def _write(base: str, step: int, flat: dict[str, Any],
           extra: dict | None) -> str:
    os.makedirs(base, exist_ok=True)
    host = {k: _to_numpy(v) for k, v in flat.items()}
    final = step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {
        "step": step,
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in host.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic on POSIX
    latest_tmp = os.path.join(base, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(base, "LATEST"))
    return final


def latest_step(base: str) -> int | None:
    """Newest valid checkpoint step (via LATEST, falling back to a scan)."""
    try:
        with open(os.path.join(base, "LATEST")) as f:
            name = f.read().strip()
        if os.path.exists(os.path.join(base, name, "manifest.json")):
            return int(name.split("_")[1])
    except (FileNotFoundError, ValueError, IndexError):
        pass
    best = None
    if os.path.isdir(base):
        for name in os.listdir(base):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(base, name, "manifest.json")):
                    s = int(name.split("_")[1])
                    best = s if best is None else max(best, s)
    return best


def restore(base: str, step: int, template: Any, shardings: Any = None,
            device=None) -> tuple[Any, dict]:
    """Load a step into ``template``'s structure -> (tree, extra).

    ``template`` supplies the structure, shapes and dtypes (tensors, e.g.
    the ``meta`` tensors of ``train.step.abstract_state``); each
    array is cast to its template leaf's dtype and put on ``device``, or,
    when ``device`` is None, on the template leaf's device (a ``meta``
    template: CUDA). ``shardings`` (a tree of ``NamedSharding`` like the
    template's, ``train.step.state_shardings``) is the reference's elastic
    reshard: each leaf becomes a DTensor of which this rank keeps its block,
    by default on its mesh's device type."""
    sh = None if shardings is None else _flatten(shardings, NamedSharding)
    d = step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten_like(template, flat)
    want = _flatten(template)
    out = {}
    for key, arr in _flatten(tree).items():
        tmpl = want[key]
        dev = device if device is not None else (
            sh[key].mesh.device_type if sh is not None else
            "cuda" if tmpl.device.type == "meta" else tmpl.device)
        out[key] = torch.as_tensor(arr).to(device=dev, dtype=tmpl.dtype)
        if sh is not None:
            out[key] = place(sh[key], out[key])
    return _unflatten_like(template, out), manifest.get("extra", {})


class AsyncSaver:
    """Snapshot-now, write-later checkpointing (overlaps I/O with compute)."""

    def __init__(self, base: str, keep: int = 3):
        self.base = base
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._sharded = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:       # every rank, once rank 0's write is done
            self._sharded = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: dict | None = None,
             on_done: Callable[[str], None] | None = None):
        self.wait()                              # one in flight at a time
        # a host copy now: training goes on writing the tensors in place
        flat, self._sharded = _gathered(tree)
        if self._sharded and not _writes():
            return
        host = {k: (v.detach().to("cpu", copy=True)
                    if isinstance(v, torch.Tensor) else np.array(v))
                for k, v in flat.items()}

        def work():
            try:
                path = _write(self.base, step, host, extra)
                self._gc()
                if on_done:
                    on_done(path)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.base)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(step_dir(self.base, s), ignore_errors=True)
