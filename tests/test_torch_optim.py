"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's: the schedule bit for bit, one and three updates within 1e-6
relative (weight decay on the layer-stacked (L, D) norm weights, not on
the final norm), the non-finite skip, the global norm and the clip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_util import flat_jax, flat_port, pair

from repro.optim import adamw as jadamw
from repro_torch.models.common import tree_leaves, tree_set
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

SCHEDULES = [dict(lr=1e-3, warmup_steps=4, total_steps=40),
             dict(lr=3e-4, warmup_steps=100, total_steps=1000),
             dict(lr=1e-3, warmup_steps=10, total_steps=100),
             dict(lr=7e-4, warmup_steps=3, total_steps=17, min_lr_frac=0.05),
             dict(lr=1e-3, warmup_steps=0, total_steps=9)]


@pytest.mark.parametrize("oc", SCHEDULES,
                         ids=[f"w{o['warmup_steps']}-t{o['total_steps']}"
                              for o in SCHEDULES])
def test_lr_at_is_bit_equal_to_reference(oc):
    """Every step from 0 to total_steps + 5, bit for bit."""
    jc, tc = jadamw.OptConfig(**oc), tadamw.OptConfig(**oc)
    steps = range(oc["total_steps"] + 6)
    want = np.array([np.asarray(jadamw.lr_at(jc, jnp.int32(s)))
                     for s in steps])
    got = np.array([tadamw.lr_at(tc, torch.tensor(s, dtype=torch.int32))
                    .numpy() for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _grads(jp, seed: int, scale: float = 0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        scale * rng.standard_normal(p.shape).astype(np.float32)), jp)


def _port_tree(jtree) -> dict:
    out: dict = {}
    for path, v in flat_jax(jtree).items():
        tree_set(out, path, torch.from_numpy(v.copy()))
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_steps_match_reference(n_steps):
    """1 and 3 updates (the third with a gradient norm under the clip);
    params, both moments and the metrics within 1e-6 relative."""
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg, jp, tcfg, tp = pair("smollm-135m", seed=0, requires_grad=True)
    jo, to = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    for i in range(n_steps):
        g = _grads(jp, i, scale=0.1 if i < 2 else 1e-4)
        jp, jo, jm = jadamw.adamw_update(jp, g, jo, jadamw.OptConfig(**oc))
        tp, to, tm = tadamw.adamw_update(tp, _port_tree(g), to,
                                         tadamw.OptConfig(**oc))
        for k in ("grad_norm", "lr", "skipped"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(to["step"]) == int(jo["step"]) == n_steps
    assert to["step"].dtype == torch.int32
    for name, got, want in (("params", flat_port(tp), flat_jax(jp)),
                            ("m", flat_port(to["m"]), flat_jax(jo["m"])),
                            ("v", flat_port(to["v"]), flat_jax(jo["v"]))):
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f"{name} {path}")


def test_weight_decay_on_stacked_norms_not_on_the_final_norm():
    """With zero gradients only the decay moves a leaf: the stacked (L, D)
    norm weights shrink by lr * wd, ``final_norm`` (D,) does not move."""
    oc = tadamw.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                          weight_decay=0.5)
    _, _, _, tp = pair("smollm-135m", seed=0, requires_grad=True)
    before = flat_port(tp)
    zeros = {}
    for path, p in tree_leaves(tp.tree()):
        tree_set(zeros, path, torch.zeros_like(p))
    tp, _, m = tadamw.adamw_update(tp, zeros, tadamw.init_opt_state(tp), oc)
    after = flat_port(tp)
    lr = float(m["lr"])
    np.testing.assert_array_equal(after["final_norm"], before["final_norm"])
    for path in ("stage_0.ln1", "stage_0.ln2", "stage_0.attn.wq"):
        assert before[path].ndim >= 2
        np.testing.assert_allclose(after[path],
                                   before[path] * (1 - lr * 0.5), rtol=1e-6)


def test_nonfinite_grads_skip_the_update_and_advance_the_step():
    """As ``tests/test_train.py::test_nonfinite_grads_skipped``."""
    jcfg, jp, tcfg, tp = pair("smollm-135m", seed=0, requires_grad=True)
    oc = tadamw.OptConfig(lr=1e-3, warmup_steps=4, total_steps=40)
    before = flat_port(tp)
    bad = {}
    for path, p in tree_leaves(tp.tree()):
        tree_set(bad, path, torch.full(p.shape, float("nan")))
    opt = tadamw.init_opt_state(tp)
    tp, o2, m = tadamw.adamw_update(tp, bad, opt, oc)
    assert float(m["skipped"]) == 1.0
    for path, v in flat_port(tp).items():
        np.testing.assert_array_equal(v, before[path])
    for name in ("m", "v"):
        assert all(float(t.abs().max()) == 0.0
                   for _, t in tree_leaves(o2[name]))
    assert int(o2["step"]) == 1


def test_global_norm_and_clip_match_reference():
    """A bf16 and an f32 leaf: the norm in float32, the scale cast to each
    leaf's dtype."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    jt = {"a": jnp.asarray(a).astype(jnp.bfloat16), "b": jnp.asarray(b)}
    tt = {"a": torch.from_numpy(a).to(torch.bfloat16),
          "b": torch.from_numpy(b)}
    np.testing.assert_allclose(float(tadamw.global_norm(tt)),
                               float(jadamw.global_norm(jt)), rtol=1e-6)
    jc, jn = jadamw.clip_by_global_norm(jt, 1.0)
    tc, tn = tadamw.clip_by_global_norm(tt, 1.0)
    assert tc["a"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in jt:
        np.testing.assert_allclose(tc[k].float().numpy(),
                                   np.asarray(jc[k].astype(jnp.float32)),
                                   rtol=1e-2 if k == "a" else 1e-6)


def test_moment_dtype_and_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(tadamw.OptConfig)] == [
        f.name for f in dataclasses.fields(jadamw.OptConfig)]
    assert tadamw.OptConfig() == tadamw.OptConfig(
        **dataclasses.asdict(jadamw.OptConfig()))
    _, _, _, tp = pair("smollm-135m", seed=0)
    opt = tadamw.init_opt_state(tp, "bfloat16")
    assert all(t.dtype == torch.bfloat16 for _, t in tree_leaves(opt["m"]))
