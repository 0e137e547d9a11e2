"""Training step: loss + grad + AdamW, microbatched, on one card or on a
mesh (port of ``repro.train.step``).

**Grain size control, the training-side analogue** (DESIGN.md §4): the
global batch is split into ``n_microbatches`` grains, each a forward and a
backward, their gradients accumulated in ``accum_dtype`` (float32). As with
the paper's nTasks dial, more grains trade per-step live activation memory
against loop overhead; the gradients do not change (the grain is
numerically neutral, ``tests/test_torch_train_step.py``).

The state is ``{"params": TransformerLM (trainable), "opt": {"m", "v",
"step"}}``, the reference's tree: it flattens to the reference's checkpoint
keys (``checkpoint.store``). The step updates it in place and returns it.

On a mesh (a ``torch.distributed`` ``DeviceMesh``) the state and the batch
are DTensors: ``state_shardings`` places the state by ``state_axes``
(moments like params, ``step`` replicated), ``batch_shardings`` the batch
by its leading axis, and ``jit_train_step`` — the reference's ``jax.jit``
with shardings — places them and runs a step under the mesh's rules, the
same ``make_train_step``. ``make_train_step_compressed`` averages the
gradients across pods with int8 on the wire (``optim.compression``).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.launch.mesh import axis_names, mesh_dims
from repro_torch.models import api
from repro_torch.models.common import (ModelConfig, torch_dtype, tree_leaves,
                                       tree_map, tree_set)
from repro_torch.models.transformer import TransformerLM, as_tree
from repro_torch.optim import adamw
from repro_torch.sharding import rules as shr

BATCH_KEYS = ("tokens", "labels", "mask", "patches", "frames")


def _device(device) -> torch.device:
    return torch.device("cuda") if device is None else torch.device(device)


def make_state(cfg: ModelConfig, seed: int = 0,
               moment_dtype: str = "float32", device=None) -> dict:
    """Fresh trainable weights from ``seed`` (``api.init_params``) and zero
    moments, on ``device`` (``None`` = CUDA)."""
    params = api.init_params(cfg, seed, _device(device), requires_grad=True)
    return {"params": params,
            "opt": adamw.init_opt_state(params, moment_dtype)}


def abstract_state(cfg: ModelConfig, moment_dtype: str = "float32",
                   trainable: bool = False) -> dict:
    """The state tree as ``meta`` tensors (no memory): a restore's
    template. ``trainable``: the params a ``TransformerLM`` whose leaves
    require grad, as ``make_state``'s do (the dry-run's train step)."""
    params = api.abstract_params(cfg)
    if trainable:
        params = TransformerLM(cfg, params, requires_grad=True)
    mdt = torch_dtype(moment_dtype)
    mom = lambda p: torch.empty(p.shape, dtype=mdt, device="meta")
    tree = as_tree(params)
    return {"params": params,
            "opt": {"m": tree_map(mom, tree), "v": tree_map(mom, tree),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def state_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tree parallel to the state (moments like params)."""
    axes = api.param_axes(cfg)
    return {"params": axes,
            "opt": {"m": tree_map(lambda a: a, axes),
                    "v": tree_map(lambda a: a, axes), "step": ()}}


def trainable_state(cfg: ModelConfig, state: dict) -> dict:
    """A state whose ``params`` is a dict tree (a restore's) with its
    params as a trainable ``TransformerLM``, the tensors shared."""
    params = state["params"]
    if not isinstance(params, TransformerLM):
        params = TransformerLM(cfg, params, requires_grad=True)
    return {"params": params, "opt": state["opt"]}


def _split_micro(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...) for every present batch leaf. A DTensor
    leaf split over its batch is gathered whole first (a microbatch spans
    a few ranks' rows; the model's first annotation splits each again)."""
    def sp(x):
        B = x.shape[0]
        assert B % n == 0, (B, n)
        if isinstance(x, DTensor) and n > 1:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard(0) else p for p in x.placements])
        return x.reshape(n, B // n, *x.shape[1:])
    return {k: sp(v) for k, v in batch.items() if k in BATCH_KEYS}


def _value_and_grad(cfg: ModelConfig, params, batch: dict):
    """(loss, {path: grad}) of ``api.loss`` at ``params``."""
    leaves = tree_leaves(as_tree(params))
    loss = api.loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.detach(), dict(zip((path for path, _ in leaves), grads))


def _as_tree(flat: dict) -> dict:
    out: dict = {}
    for path, g in flat.items():
        tree_set(out, path, g)
    return out


def _mean_grads(cfg: ModelConfig, params, batch: dict, n_micro: int,
                accum_dtype=torch.float32):
    """Microbatch-accumulated (loss, grads), the grain-size loop. One grain:
    the gradients in the parameters' dtype. Several: each grain's gradients
    added into ``accum_dtype`` zeros in grain order, then scaled by
    ``1 / n_micro`` — staying in ``accum_dtype``, as the reference's do
    (its final cast is to the accumulator's own dtype)."""
    if n_micro <= 1:
        loss, grads = _value_and_grad(cfg, params, batch)
        return loss, _as_tree(grads)
    micro = _split_micro(batch, n_micro)
    leaves = tree_leaves(as_tree(params))
    acc = {path: torch.zeros_like(p, dtype=accum_dtype)
           if isinstance(p, DTensor) else
           torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
           for path, p in leaves}
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0][1].device)
    for i in range(n_micro):
        loss, g = _value_and_grad(cfg, params,
                                  {k: v[i] for k, v in micro.items()})
        loss_sum = loss_sum + loss
        for path, a in acc.items():
            a.add_(g[path].to(a.dtype))
        del g
    inv = 1.0 / n_micro
    return loss_sum * inv, _as_tree({p: a * inv for p, a in acc.items()})


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    n_microbatches: int = 1, accum_dtype=torch.float32):
    """The single-card train step: (state, batch) -> (state, metrics), the
    state updated in place; metrics ``loss``, ``grad_norm``, ``lr`` and
    ``skipped`` as 0-d tensors."""

    def step(state: dict, batch: dict):
        loss, grads = _mean_grads(cfg, state["params"], batch,
                                  n_microbatches, accum_dtype)
        params, opt, metrics = adamw.adamw_update(
            state["params"], grads, state["opt"], opt_cfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return step


# --------------------------------------------------------------- shardings ----
def _divides(path: str, spec, shape, mesh) -> None:
    """Raise ``ValueError`` naming the leaf and the dimension where a
    dimension of ``shape`` does not divide over its mesh axes in ``spec``
    (the reference's ``device_put`` refuses the same state)."""
    sizes = mesh_dims(mesh)
    for dim, (n, entry) in enumerate(zip(shape, spec)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        parts = math.prod(sizes[a] for a in axes)
        if n % parts:
            raise ValueError(
                f"state_shardings: {path} dimension {dim} of size {n} does "
                f"not divide over mesh axes {axes} ({parts} ways) of the "
                f"mesh {sizes}")


def state_shardings(mesh, cfg: ModelConfig, rules=None) -> dict:
    """A ``NamedSharding`` for every leaf of the state, from
    ``state_axes``: the moments shard like the params, ``step`` is
    replicated. As in the reference, no axis is dropped where it does not
    divide: such a leaf raises ``ValueError`` here, before any work."""
    def walk(axes, shapes, path):
        if isinstance(axes, dict):
            return {k: walk(axes[k], shapes[k], f"{path}.{k}" if path else k)
                    for k in axes}
        spec = shr.logical_to_spec(axes, rules, mesh)
        _divides(path, spec, tuple(shapes.shape), mesh)
        return shr.NamedSharding(mesh, spec)

    return walk(state_axes(cfg), abstract_state(cfg), "")


def batch_shardings(mesh, batch_tree, rules=None) -> dict:
    """``("batch", None, ...)`` for every batch leaf, the batch dimension
    split where it divides (``sharding.rules.named_sharding_for``)."""
    return tree_map(lambda x: shr.named_sharding_for(
        mesh, ("batch",) + (None,) * (len(x.shape) - 1), tuple(x.shape),
        rules), batch_tree)


def _placed(t, sharding, device, copy: bool):
    """A state or batch leaf on the mesh: a DTensor as it is (a copy when
    ``copy``), anything else placed by ``sharding`` from ``device``."""
    if isinstance(t, DTensor):
        return t.detach().clone().requires_grad_(t.requires_grad) \
            if copy else t
    return shr.place(sharding, torch.as_tensor(t, device=device))


def place_state(cfg: ModelConfig, state: dict, shardings, copy: bool = False
                ) -> dict:
    """``state`` on the mesh of ``shardings`` (``state_shardings``' tree;
    may be None when every leaf is a DTensor already), its params a
    trainable ``TransformerLM``: plain leaves placed (each rank keeps a
    copy of its block), DTensor leaves kept as they are — or copied, with
    ``copy``."""
    device = None if shardings is None else torch.device(
        shardings["opt"]["step"].mesh.device_type)

    def walk(tree, sh):
        if isinstance(tree, dict):
            return {k: walk(v, None if sh is None else sh[k])
                    for k, v in tree.items()}
        return _placed(tree, sh, device, copy)

    params = walk(as_tree(state["params"]),
                  None if shardings is None else shardings["params"])
    opt = walk(state["opt"], None if shardings is None else shardings["opt"])
    old = state["params"]
    if isinstance(old, TransformerLM) and all(
            a is b for (_, a), (_, b) in zip(tree_leaves(old.tree()),
                                             tree_leaves(params))):
        params = old
    return trainable_state(cfg, {"params": params, "opt": opt})


def _is_placed(state: dict) -> bool:
    return all(isinstance(t, DTensor) for _, t in tree_leaves(
        {"params": as_tree(state["params"]), "opt": state["opt"]}))


def jit_train_step(step_fn, mesh, cfg: ModelConfig, batch_tree, rules=None,
                   donate: bool = True):
    """The step on ``mesh`` (a ``DeviceMesh``), the port's counterpart of
    the reference's ``jax.jit`` with in- and out-shardings; there is no jit
    to wrap. The returned step places a plain state by ``state_shardings``
    (raising ``ValueError`` there on a leaf that does not divide, before
    any work) and a plain batch by ``batch_shardings`` (``batch_tree``'s
    shapes), each rank keeping its block; DTensor leaves that are already
    placed stay as they are (the dry-run's divisibility-aware placements
    on a production mesh, say). It runs ``step_fn`` under the rules on the
    mesh, with plain tensors made inside the step taken as replicated, and
    returns the state — its tensors updated in place, the counterpart of
    donation; ``donate=False`` steps a copy — and the metrics as plain
    tensors, the same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    rules = rules or shr.current_rules()
    bs = batch_shardings(mesh, batch_tree, rules)
    device = torch.device(mesh.device_type)
    shardings = functools.cache(lambda: state_shardings(mesh, cfg, rules))

    def step(state: dict, batch: dict):
        state = place_state(cfg, state, None if _is_placed(state)
                            else shardings(), copy=not donate)
        batch = {k: _placed(v, bs[k], device, False)
                 for k, v in batch.items()}
        with shr.use_rules(rules, mesh), implicit_replication():
            state, metrics = step_fn(state, batch)
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}

    return step


def make_train_step_compressed(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                               mesh, n_microbatches: int = 1,
                               pod_axis: str = "pod"):
    """The step whose cross-pod gradient mean has int8 on the wire, on a
    ``DeviceMesh`` with a ``pod_axis`` (the reference's ``shard_map``
    manual over ``pod`` only). Each pod takes the gradients of its slice
    of the batch with the DTensor step on the other axes' sub-mesh (its
    state's blocks and its batch rows, the same local tensors: no copy);
    the gradients are averaged over the pods by ``compressed_psum_tree``
    over ``pod_axis`` and the loss by an exact all-reduce; AdamW then
    updates the blocks in place. Run it through ``jit_train_step`` on
    ``mesh`` (the state replicated over the pods, the batch split over
    them), which returns the metrics replicated."""
    import torch.distributed as dist

    from repro_torch.optim.compression import compressed_psum_tree

    names = axis_names(mesh)
    n_pods = mesh_dims(mesh)[pod_axis]
    keep = [i for i, a in enumerate(names) if a != pod_axis]
    inner = tuple(names[i] for i in keep)
    sub = mesh[inner if len(inner) > 1 else inner[0]]
    pod_group = mesh.get_group(pod_axis)

    def local(x):
        """``x`` (on ``mesh``) as a DTensor on ``sub`` over the same local
        block."""
        return DTensor.from_local(x.to_local().detach(), sub,
                                  [x.placements[i] for i in keep],
                                  run_check=False)

    def step(state: dict, batch: dict):
        params = TransformerLM(cfg, tree_map(local, as_tree(state["params"])),
                               requires_grad=True)
        opt = {"m": tree_map(local, state["opt"]["m"]),
               "v": tree_map(local, state["opt"]["v"]),
               "step": local(state["opt"]["step"])}
        with shr.use_rules(shr.current_rules(), sub):
            loss, grads = _mean_grads(cfg, params, {
                k: local(v) for k, v in batch.items()}, n_microbatches)
            placements = dict(tree_leaves(params.tree()))
            grads = _as_tree({
                path: g.redistribute(sub, placements[path].placements)
                for path, g in tree_leaves(grads)})
            grads = tree_map(lambda g: g / n_pods, compressed_psum_tree(
                grads, pod_axis, mesh=mesh))
            loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
            dist.all_reduce(loss, group=pod_group)
            _, opt, metrics = adamw.adamw_update(params, grads, opt, opt_cfg)
        metrics["loss"] = loss / n_pods
        step_count = DTensor.from_local(opt["step"].to_local(), mesh,
                                        state["opt"]["step"].placements,
                                        run_check=False)
        return {"params": state["params"],
                "opt": {**state["opt"], "step": step_count}}, metrics

    return step
