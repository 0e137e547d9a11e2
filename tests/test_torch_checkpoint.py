"""The port's on-disk checkpoint store (``repro_torch.checkpoint.store``):
the reference's own tests (``tests/test_checkpoint.py``: round trip, a
partial save ignored, a shape mismatch rejected, the async saver and its
GC) on the port, and round trips ACROSS packages in both directions — a
checkpoint written by either restores in the other, bf16 leaf and int32
step included — and a whole training state saved by the JAX package
restoring into the port's template."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor
from torch_train_util import one_rank_mesh, pair

from repro.checkpoint import store as jstore
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import store as tstore
from repro_torch.models.common import tree_leaves
from repro_torch.train import step as tstep

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.randn(16, generator=g).to(torch.bfloat16)},
            "opt": {"m": torch.ones(8, 16),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _jtree(t):
    return jax.tree.map(
        lambda v: jnp.asarray(v.float().numpy()).astype(
            {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
             torch.int32: jnp.int32}[v.dtype]), t)


def _assert_equal(got, want):
    g, w = tstore._flatten(got), tstore._flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k


def test_roundtrip(tmp_path):
    t = _tree()
    tstore.save(str(tmp_path), 5, t, extra={"data_step": 6})
    assert tstore.latest_step(str(tmp_path)) == 5
    got, extra = tstore.restore(str(tmp_path), 5, t)
    assert extra == {"data_step": 6}
    _assert_equal(got, t)


def test_latest_ignores_partial(tmp_path):
    tstore.save(str(tmp_path), 5, _tree())
    # a crashed save: tmp dir + corrupt LATEST must not break restore
    os.makedirs(tmp_path / "step_000000009.tmp")
    (tmp_path / "LATEST").write_text("step_000000099")
    assert tstore.latest_step(str(tmp_path)) == 5
    assert tstore.latest_step(str(tmp_path / "missing")) is None


def test_shape_mismatch_rejected(tmp_path):
    t = _tree()
    tstore.save(str(tmp_path), 1, t)
    bad = {"params": {k: torch.zeros((3, *v.shape), dtype=v.dtype)
                      for k, v in t["params"].items()}, "opt": t["opt"]}
    with pytest.raises(ValueError, match="shape"):
        tstore.restore(str(tmp_path), 1, bad)


def test_async_saver_and_gc(tmp_path):
    s = tstore.AsyncSaver(str(tmp_path), keep=2)
    t = _tree()
    for step in (1, 2, 3, 4):
        s.save(step, t, extra={"data_step": step})
        s.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    assert tstore.latest_step(str(tmp_path)) == 4


def test_async_saver_snapshots_at_save_time(tmp_path):
    """The host copy is taken when ``save`` is called: an in-place write
    after it (training goes on) does not reach the checkpoint."""
    s = tstore.AsyncSaver(str(tmp_path), keep=2)
    t = _tree()
    want = {k: v.clone() for k, v in tstore._flatten(t).items()}
    s.save(1, t)
    t["params"]["w"].add_(1.0)
    s.wait()
    got, _ = tstore.restore(str(tmp_path), 1, t)
    assert torch.equal(got["params"]["w"], want["params/w"])


def test_async_saver_surfaces_errors(tmp_path):
    (tmp_path / "file").write_text("x")
    s = tstore.AsyncSaver(str(tmp_path / "file"), keep=2)
    s.save(1, _tree())
    with pytest.raises(OSError):
        s.wait()


def test_port_checkpoint_restores_in_jax(tmp_path):
    t = _tree(1)
    tstore.save(str(tmp_path), 3, t, extra={"data_step": 4})
    assert jstore.latest_step(str(tmp_path)) == 3
    got, extra = jstore.restore(str(tmp_path), 3, _jtree(t))
    assert extra == {"data_step": 4}
    assert got["params"]["b"].dtype == jnp.bfloat16
    assert got["opt"]["step"].dtype == jnp.int32 and int(got["opt"]["step"]) == 7
    for k, v in tstore._flatten(t).items():
        np.testing.assert_array_equal(
            np.asarray(jstore._flatten(got)[k]).astype(np.float32),
            v.float().numpy(), err_msg=k)


def test_jax_checkpoint_restores_in_port(tmp_path):
    t = _tree(2)
    jstore.save(str(tmp_path), 8, _jtree(t), extra={"data_step": 9})
    assert tstore.latest_step(str(tmp_path)) == 8
    got, extra = tstore.restore(str(tmp_path), 8, t)
    assert extra == {"data_step": 9}
    _assert_equal(got, t)


def test_jax_training_state_restores_into_the_ports_template(tmp_path):
    """A JAX ``make_state`` (bf16 params, f32 moments, int32 step) saved by
    the JAX store restores into the port's ``abstract_state`` (meta
    tensors) on the CPU, leaf for leaf equal to
    ``convert.train_state_from_numpy`` of the same state; saved again by
    the port, it restores in the JAX package."""
    jcfg, _, tcfg, _ = pair("smollm-135m", seed=0,
                            param_dtype="bfloat16", compute_dtype="bfloat16")
    state = jstep.make_state(jcfg, jax.random.key(3))
    host = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), state)
    jstore.save(str(tmp_path / "j"), 0, state, extra={"data_step": 0})
    got, _ = tstore.restore(str(tmp_path / "j"), 0,
                            tstep.abstract_state(tcfg), device="cpu")
    want = convert.train_state_from_numpy(host, tcfg, "cpu")
    back_host = convert.train_state_to_numpy(want)
    assert jax.tree.structure(back_host) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back_host), jax.tree.leaves(host)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    want = {"params": want["params"].tree(), "opt": want["opt"]}
    _assert_equal(got, want)
    assert got["params"]["embed"]["embedding"].dtype == torch.bfloat16
    tstore.save(str(tmp_path / "t"), 0, tstep.trainable_state(tcfg, got))
    back, _ = jstore.restore(str(tmp_path / "t"), 0,
                             jstep.abstract_state(jcfg))
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(state),
                         jax.tree.leaves(back)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))


def test_module_flattens_as_its_tree():
    """A ``TransformerLM`` flattens to the reference's param keys."""
    _, jp, tcfg, tp = pair("smollm-135m", seed=0)
    keys = set(tstore._flatten({"params": tp}))
    assert keys == {"params/" + k for k in jstore._flatten(jp)}
    assert {k.replace("/", ".") for k in tstore._flatten(tp)} == {
        p for p, _ in tree_leaves(tp.tree())}


def test_formerly_refused_restore_with_shardings(tmp_path):
    """``restore(shardings=)`` of a JAX-written training state onto a 1 x 1
    mesh of one gloo rank: every leaf a DTensor with its sharding's
    placements on the mesh's device, equal bit for bit to the unsharded
    restore."""
    jcfg, jp, tcfg, _ = pair("smollm-135m", seed=1)
    jstore.save(str(tmp_path), 3, {"params": jp, "opt": jstep.make_state(
        jcfg, jax.random.key(1))["opt"]}, extra={"data_step": 3})
    template = tstep.abstract_state(tcfg)
    plain, _ = tstore.restore(str(tmp_path), 3, template, device="cpu")
    with one_rank_mesh(("data", "model")) as mesh:
        sh = tstep.state_shardings(mesh, tcfg)
        got, extra = tstore.restore(str(tmp_path), 3, template, sh)
        flat_sh = tstore._flatten(sh, type(sh["opt"]["step"]))
        want = tstore._flatten(plain)
        assert extra == {"data_step": 3}
        for k, v in tstore._flatten(got).items():
            assert isinstance(v, DTensor) and v.device.type == "cpu", k
            assert tuple(v.placements) == flat_sh[k].placements, k
            assert v.dtype == want[k].dtype and torch.equal(
                v.full_tensor(), want[k]), k
