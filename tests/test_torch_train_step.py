"""The port's train step (``repro_torch.train.step``) against the JAX
package's: the microbatch grain is numerically neutral (as
``tests/test_train.py::test_microbatch_grain_equivalence``) and equal to
the reference's accumulation; remat and the chunked loss leave the
gradients as they were; three whole steps of ``make_train_step`` (the
parameters updated in place, the trainable module's per-layer views made
anew each step) follow the reference's, loss for loss and leaf for leaf."""

import jax
import numpy as np
import pytest
import torch
from torch_train_util import (TOL, assert_trees_close, batch, family_pair,
                              flat_jax, flat_port, pair, to_jax, to_torch)

from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttfm
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


@pytest.mark.parametrize("call", [
    lambda: tstep.make_train_step_compressed(None, None, mesh=object()),
    lambda: tstep.state_shardings(object(), None),
    lambda: tstep.batch_shardings(object(), {}),
    lambda: tstep.jit_train_step(None, object(), None, {})],
    ids=["compressed", "state_shardings", "batch_shardings",
         "jit_train_step"])
def test_multi_card_step_refuses_naming_the_multi_card_row(call):
    with pytest.raises(NotImplementedError, match="multi-card row"):
        call()
