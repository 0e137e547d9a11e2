"""Shared helpers of the tests/test_torch_train*.py suites: the same model,
weights and batches in the JAX package and in the port, and leaf-by-leaf
comparison of trees of gradients or parameters by dotted path."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch_fn as jmake_batch_fn
from repro.models import api as japi
from repro_torch import convert
from repro_torch.models.common import tree_leaves

# the families test_archs.py::test_train_step_finite trains, as reduced
# twins of at most 3 layers: xLSTM as one segment of an mLSTM and an sLSTM
# block, zamba2 as a segment of 2 Mamba-2 blocks and a shared attention
# block, then one more Mamba-2 block
FAMILIES = {
    "dense": ("smollm-135m", {}),
    "moe": ("qwen3-moe-235b-a22b", {}),
    "mla": ("deepseek-v2-236b", {}),
    "zamba2": ("zamba2-7b", dict(n_layers=3, attn_every=2)),
    "xlstm": ("xlstm-1.3b", dict(n_layers=2, slstm_every=2)),
    "vlm": ("paligemma-3b", {}),
    "encdec": ("seamless-m4t-medium", {}),
}
SRC_LEN = 12            # the encdec family's stub frames
TOL = 1e-4              # a gradient leaf's max abs diff / its largest value
TOL_XLSTM = 1e-3        # the xLSTM twin's (its exponential gates)
# a leaf whose reference gradient is zero in exact arithmetic (the sLSTM's
# input-gate bias: h = c/n does not move when every input-gate
# pre-activation shifts together) holds rounding noise in both packages:
# each leaf's scale is floored at this fraction of the tree's largest
# gradient
ZERO_FLOOR = 1e-5


def pair(arch: str, seed: int = 0, requires_grad: bool = False, **kw):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jconfigs.reduced_config(arch).replace(**kw)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    jp = japi.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(lambda a: np.array(a.astype(jnp.float32)), jp)
    return jcfg, jp, tcfg, convert.params_from_numpy(
        tree, tcfg, "cpu", requires_grad=requires_grad)


def family_pair(family: str, seed: int = 0, requires_grad: bool = False,
                **kw):
    arch, over = FAMILIES[family]
    return pair(arch, seed, requires_grad, **{**over, **kw})


def batch(jcfg, seq_len: int = 16, global_batch: int = 4, seed: int = 3,
          step: int = 0, zero_mask: bool = False) -> dict:
    """One numpy batch of the reference's pipeline (with stub patches or
    frames by family); ``zero_mask`` masks out the first row's first 5
    labels."""
    b = jmake_batch_fn(JDataConfig(seq_len=seq_len,
                                   global_batch=global_batch, seed=seed),
                       jcfg, src_len=SRC_LEN)(step)
    if zero_mask:
        b["mask"][0, :5] = 0.0
    return b


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def flat_jax(tree) -> dict:
    """{dotted path: numpy float32} of a JAX tree of dicts."""
    return {".".join(str(k.key) for k in path): np.asarray(
        jnp.asarray(v).astype(jnp.float32))
        for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def flat_port(tree) -> dict:
    """{dotted path: numpy float32 copy} of a port tree (or module)."""
    tree = tree.tree() if hasattr(tree, "tree") else tree
    return {path: None if v is None else v.detach().float().numpy().copy()
            for path, v in tree_leaves(tree)}


def leaf_errors(got: dict, want: dict) -> dict:
    """{path: max abs diff / max(the leaf's largest magnitude, ZERO_FLOOR x
    the tree's largest)}; every path of ``want`` must be in ``got`` with a
    value (not None) of its shape."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    top = max(float(np.abs(w).max()) for w in want.values())
    out = {}
    for path, w in want.items():
        g = got[path]
        assert g is not None, f"{path}: no gradient in the port"
        assert g.shape == w.shape, (path, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), ZERO_FLOOR * top, 1e-30)
        out[path] = float(np.abs(g - w).max()) / scale
    return out


def assert_trees_close(got: dict, want: dict, tol: float, what: str = ""):
    errs = leaf_errors(got, want)
    bad = {p: e for p, e in errs.items() if e > tol}
    assert not bad, f"{what}: leaves beyond {tol} of their scale: {bad}"


@contextlib.contextmanager
def one_rank_mesh(names: tuple[str, ...]):
    """A ``DeviceMesh`` of 1 x ... x 1 over a gloo group of this process
    alone (``launch.mesh.process_group``), torn down on exit: the port's
    mesh paths in this process, against the reference's on one host
    device."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as lmesh
    with lmesh.process_group("cpu"):
        yield DeviceMesh("cpu", torch.zeros((1,) * len(names), dtype=int),
                         mesh_dim_names=names)


def spec_lists(shardings, leaf_type) -> dict:
    """{path: spec as lists} of a tree of either package's shardings."""
    from repro_torch.checkpoint import store
    return {k: [list(e) if isinstance(e, tuple) else e for e in s.spec]
            for k, s in store._flatten(shardings, leaf_type).items()}
