"""The port's train step (``repro_torch.train.step``) against the JAX
package's: the microbatch grain is numerically neutral (as
``tests/test_train.py::test_microbatch_grain_equivalence``) and equal to
the reference's accumulation; remat and the chunked loss leave the
gradients as they were; three whole steps of ``make_train_step`` (the
parameters updated in place, the trainable module's per-layer views made
anew each step) follow the reference's, loss for loss and leaf for leaf.
The mesh half on a mesh of one gloo rank (``jit_train_step``, the
compressed step, the shardings) against the reference's on its one host
device; on 4 ranks in ``test_torch_sharded_train.py``."""

import jax
import numpy as np
import pytest
import torch
from torch_train_util import (TOL, assert_trees_close, batch, family_pair,
                              flat_jax, flat_port, one_rank_mesh, pair,
                              spec_lists, to_jax, to_torch)

from repro import configs as jconfigs
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import store as tstore
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttfm
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)


def test_microbatch_grain_equivalence():
    """1 and 4 microbatches: the same loss and gradients (the reference's
    test's tolerances), and 4 equal to the reference's 4, whose gradients
    stay in the float32 accumulator's dtype."""
    jcfg, jp, tcfg, tp = pair("smollm-135m", seed=0, requires_grad=True)
    b = batch(jcfg, seq_len=32, global_batch=8, seed=5)
    l1, g1 = tstep._mean_grads(tcfg, tp, to_torch(b), 1)
    l4, g4 = tstep._mean_grads(tcfg, tp, to_torch(b), 4)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    f1, f4 = flat_port(g1), flat_port(g4)
    for k in f1:
        np.testing.assert_allclose(f1[k], f4[k], atol=2e-5, rtol=2e-3)
    jl4, jg4 = jstep._mean_grads(jcfg, jp, to_jax(b), 4)
    np.testing.assert_allclose(float(l4), float(jl4), rtol=1e-5)
    assert_trees_close(f4, flat_jax(jg4), TOL, "4 microbatches")
    bf16 = tcfg.replace(param_dtype="bfloat16")
    _, g2 = tstep._mean_grads(
        bf16, tapi.init_params(bf16, 0, "cpu", requires_grad=True),
        to_torch(b), 2)
    assert all(g.dtype == torch.float32 for g in g2["stage_0"]["attn"].values())


def test_split_micro_keeps_the_batch_keys():
    b = {"tokens": torch.zeros(8, 3), "labels": torch.zeros(8, 3),
         "other": torch.zeros(8)}
    out = tstep._split_micro(b, 4)
    assert sorted(out) == ["labels", "tokens"]
    assert out["tokens"].shape == (4, 2, 3)
    assert tstep.BATCH_KEYS == jstep.BATCH_KEYS


@pytest.mark.parametrize("family,over", [
    ("dense", dict(remat="full")), ("dense", dict(remat="dots")),
    ("dense", dict(logits_chunk=4)), ("zamba2", dict(remat="full")),
    ("xlstm", dict(remat="full")), ("encdec", dict(remat="full"))],
    ids=["dense-full", "dense-dots", "dense-chunk4", "zamba2-full",
         "xlstm-full", "encdec-full"])
def test_remat_and_chunked_loss_leave_gradients_unchanged(family, over):
    """Recomputation (``_maybe_remat``) and the chunked loss's checkpointed
    chunks give the gradients of the plain run (to float32 rounding) and
    every leaf a gradient."""
    _, _, tcfg, tp = family_pair(family, seed=6, requires_grad=True)
    jcfg, _, _, _ = family_pair(family, seed=6)
    b = to_torch(batch(jcfg, zero_mask=True))
    lp, gp = tstep._mean_grads(tcfg, tp, b, 1)
    lr_, gr = tstep._mean_grads(tcfg.replace(**over), tp, b, 1)
    np.testing.assert_allclose(float(lr_), float(lp), rtol=1e-6)
    assert_trees_close(flat_port(gr), flat_port(gp), 1e-5, str(over))


def test_three_train_steps_match_reference():
    """``make_train_step`` with 2 microbatches, three steps on three
    batches: losses within 1e-5 relative, parameters and moments leaf for
    leaf within the gradient tolerance, at ``tests/test_train.py``'s
    schedule (AdamW's normalised update moves an element whose gradient
    is near zero by up to ~lr whatever its size, so float32 rounding there
    shows in the parameters in proportion to lr). The port updates the
    trainable module in place; a stale per-layer view would keep step 1's
    weights and part from the reference at step 2."""
    jcfg, jp, tcfg, tp = pair("smollm-135m", seed=2, requires_grad=True)
    oc = dict(lr=1e-3, warmup_steps=4, total_steps=40)
    jstate = {"params": jp, "opt": jadamw.init_opt_state(jp)}
    tstate = {"params": tp, "opt": tadamw.init_opt_state(tp)}
    jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**oc), 2))
    tfn = tstep.make_train_step(tcfg, tadamw.OptConfig(**oc), 2)
    for i in range(3):
        b = batch(jcfg, seq_len=16, global_batch=4, seed=7, step=i)
        jstate, jm = jfn(jstate, to_jax(b))
        tstate, tm = tfn(tstate, to_torch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        assert float(tm["skipped"]) == 0.0
        assert float(tm["lr"]) == float(jm["lr"])
    assert tstate["params"] is tp
    assert_trees_close(flat_port(tp), flat_jax(jstate["params"]), TOL,
                       "params")
    assert int(tstate["opt"]["step"]) == 3


def test_trainable_module_views():
    """Serving's views are built once with no autograd history; a forward
    with grad enabled makes fresh ones that carry gradients into the
    stacked leaves; an in-place update is seen by both."""
    _, _, tcfg, tp = pair("smollm-135m", seed=0, requires_grad=True)
    assert tp.trainable and not tapi.init_params(tcfg, 0, "cpu").trainable
    cached = tp._layers[0][0][0]["ln1"]
    assert cached.grad_fn is None      # made under no_grad: no history
    with torch.no_grad():
        assert ttfm._layers(tp, tcfg) is tp._layers
    fresh = ttfm._layers(tp, tcfg)
    assert fresh is not tp._layers
    assert fresh[0][0][0]["ln1"].grad_fn is not None
    toks = torch.arange(1, 9, dtype=torch.int32)[None]
    loss = tapi.loss(tp, tcfg, {"tokens": toks, "labels": toks})
    loss.backward()
    stacked = tp.tree()["stage_0"]["ln1"]
    assert stacked.grad is not None and stacked.grad.shape == stacked.shape
    assert bool((stacked.grad != 0).all())
    with torch.no_grad():
        stacked.mul_(2.0)
    assert torch.equal(cached, stacked[0])
    with torch.no_grad():
        served, _ = tapi.prefill(tp, tcfg, {"tokens": toks}, 8)
        fresh_model = ttfm.TransformerLM(tcfg, _nested(tp.tree()))
        want, _ = tapi.prefill(fresh_model, tcfg, {"tokens": toks}, 8)
    assert torch.equal(served, want)


def _nested(tree):
    return {k: _nested(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _compressed(jcfg, tcfg, oc, mesh, jmesh):
    return (tstep.make_train_step_compressed(tcfg, tadamw.OptConfig(**oc),
                                             mesh),
            jstep.make_train_step_compressed(jcfg, jadamw.OptConfig(**oc),
                                             jmesh))


def _plain(jcfg, tcfg, oc, mesh, jmesh):
    return (tstep.make_train_step(tcfg, tadamw.OptConfig(**oc), 2),
            jstep.make_train_step(jcfg, jadamw.OptConfig(**oc), 2))


@pytest.mark.parametrize("names,make", [
    (("pod", "data", "model"), _compressed),
    (("data", "model"), _plain)], ids=["compressed", "jit_train_step"])
def test_formerly_refused_mesh_steps_match_reference(names, make):
    """One step through ``jit_train_step`` on a 1 x 1 (x 1) mesh of one
    gloo rank — the compressed step (int8 over a pod axis of one) and the
    plain step in 2 microbatches — against the reference's
    ``jit_train_step`` on a mesh of its one host device: the loss within
    1e-5, the gradient norm within 1e-4 relative, and the parameters after
    the step within the gradient tolerance (eps 1e-3: AdamW's first step
    is then a smooth function of the gradient, which the int8 rounding
    otherwise flips near zero). The port's state comes back as DTensors,
    its metrics as plain tensors."""
    from torch.distributed.tensor import DTensor

    from repro.compat import make_auto_mesh
    jcfg, jp, tcfg, tp = pair("smollm-135m", seed=4, requires_grad=True)
    oc = dict(lr=1e-3, warmup_steps=4, total_steps=40, eps=1e-3)
    b = batch(jcfg, seq_len=16, global_batch=4, seed=9)
    jmesh = make_auto_mesh((1,) * len(names), names)
    jstate = {"params": jp, "opt": jadamw.init_opt_state(jp)}
    with one_rank_mesh(names) as mesh:
        tfn, jfn = make(jcfg, tcfg, oc, mesh, jmesh)
        jfn = jstep.jit_train_step(jfn, jmesh, jcfg, b)
        tfn = tstep.jit_train_step(tfn, mesh, tcfg, b)
        jstate, jm = jfn(jstate, to_jax(b))
        tstate, tm = tfn({"params": tp, "opt": tadamw.init_opt_state(tp)},
                         to_torch(b))
        assert all(isinstance(v, torch.Tensor) and not isinstance(v, DTensor)
                   for v in tm.values())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["lr"]) == float(jm["lr"])
        params = tstate["params"].tree()
        assert all(isinstance(v, DTensor) for _, v in tree_leaves(params))
        got = {k: v.detach().full_tensor().float().numpy()
               for k, v in tree_leaves(params)}
        assert int(tstate["opt"]["step"].full_tensor()) == 1
    assert_trees_close(got, flat_jax(jstate["params"]), TOL, "params")


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("what", ["state_shardings", "batch_shardings"])
def test_formerly_refused_shardings_match_reference(what, arch):
    """Every leaf's spec on a 1 x 1 ("data", "model") mesh of one gloo
    rank equals the reference's on its one host device (no axis of size
    one is dropped), and each sharding names the port's mesh."""
    from jax.sharding import NamedSharding as JNamedSharding

    from repro.compat import make_auto_mesh
    from repro_torch.sharding.rules import NamedSharding
    jcfg = jconfigs.reduced_config(arch)
    tcfg = tconfigs.reduced_config(arch)
    jmesh = make_auto_mesh((1, 1), ("data", "model"))
    b = batch(jcfg, seq_len=16, global_batch=4, seed=9)
    with one_rank_mesh(("data", "model")) as mesh:
        if what == "state_shardings":
            got = tstep.state_shardings(mesh, tcfg)
            want = jstep.state_shardings(jmesh, jcfg)
        else:
            got = tstep.batch_shardings(mesh, b)
            want = jstep.batch_shardings(jmesh, b)
        assert all(s.mesh is mesh for s in tstore._flatten(
            got, NamedSharding).values())
        assert spec_lists(got, NamedSharding) == spec_lists(
            want, JNamedSharding)
