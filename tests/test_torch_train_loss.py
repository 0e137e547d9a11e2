"""The port's training loss against the JAX package's, on the same
converted weights and the same numpy batches: ``api.loss`` for the reduced
twin of every architecture ``tests/test_archs.py::test_train_step_finite``
trains (dense, MoE, MLA, the zamba2 hybrid, xLSTM, vlm, encdec), with
``logits_chunk`` off and on and a mask with zeros, within 1e-5 relative;
the pieces (``cross_entropy``, ``chunked_ce_loss``, the MoE load-balance
loss, ``maybe_scan``) and the abstract trees (``abstract_params``,
``param_axes``, ``abstract_state``, ``state_axes``) against theirs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_util import (FAMILIES, batch, family_pair, pair, to_jax,
                              to_torch)

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.common import tree_leaves
from repro_torch.train import step as tstep

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.mark.parametrize("chunk", [0, 4], ids=["unchunked", "chunk4"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_matches_reference(family, chunk):
    """Every family's loss, unchunked and in chunks of 4 logits positions,
    with the first row's first 5 labels masked out."""
    jcfg, jp, tcfg, tp = family_pair(family, seed=1, logits_chunk=chunk)
    b = batch(jcfg, zero_mask=True)
    want = float(japi.loss(jp, jcfg, to_jax(b)))
    got = tapi.loss(tp, tcfg, to_torch(b))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-0.5b", "qwen1.5-4b"])
def test_loss_of_the_other_dense_archs_matches_reference(arch):
    """The remaining archs of test_archs.py (dense, with qkv bias or GQA)."""
    jcfg, jp, tcfg, tp = pair(arch, seed=2)
    b = batch(jcfg, seq_len=12)
    np.testing.assert_allclose(float(tapi.loss(tp, tcfg, to_torch(b))),
                               float(japi.loss(jp, jcfg, to_jax(b))),
                               rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_cross_entropy_and_chunked_ce_match_reference(masked):
    """``cross_entropy`` on random logits; ``chunked_ce_loss`` in 1, 2 and
    4 chunks (and at a chunk that does not divide S, which goes unchunked)
    equal to the reference's and to the unchunked loss."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 8, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) > 0.3).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = float(jlayers.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(targets), jm))
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(targets), tm)
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    jcfg, jp, tcfg, tp = pair("smollm-135m", seed=3)
    x = (rng.standard_normal((2, 8, jcfg.d_model)) * 0.5).astype(np.float32)
    full = None
    for ck in (0, 2, 4, 3, 8):
        jc, tc = jcfg.replace(logits_chunk=ck), tcfg.replace(logits_chunk=ck)
        w = float(jlayers.chunked_ce_loss(jp["embed"], jc, jnp.asarray(x),
                                          jnp.asarray(targets), jm))
        g = float(tlayers.chunked_ce_loss(tp.tree()["embed"], tc,
                                          torch.from_numpy(x),
                                          torch.from_numpy(targets), tm))
        np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=f"chunk {ck}")
        full = g if full is None else full
        np.testing.assert_allclose(g, full, rtol=RTOL)


def test_fully_masked_loss_is_zero_not_nan():
    """The masked mean divides by max(mask.sum(), 1), as the reference."""
    logits = torch.randn(1, 4, 7)
    got = tlayers.cross_entropy(logits, torch.zeros(1, 4, dtype=torch.int32),
                                torch.zeros(1, 4))
    assert float(got) == 0.0


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((32, 8)).astype(np.float32)
    topi = np.argsort(-logits, axis=-1)[:, :2].astype(np.int32)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                            jnp.asarray(topi), 8))
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(topi), 8)
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_maybe_scan_matches_reference():
    """A carry and stacked outputs over a tree of stacked inputs; None
    outputs give None."""
    jcfg = jconfigs.reduced_config("smollm-135m")
    tcfg = tcommon.ModelConfig()
    xs = {"a": np.arange(12, dtype=np.float32).reshape(4, 3),
          "b": (np.ones((4, 2), np.float32), np.arange(4, dtype=np.float32))}

    def jbody(c, x):
        c = c + x["a"].sum() * x["b"][1]
        return c, {"y": x["a"] * c, "z": (x["b"][0] + c,)}

    jc, jys = jcommon.maybe_scan(jcfg, jbody, jnp.float32(1.0),
                                 jax.tree.map(jnp.asarray, xs))
    tc, tys = tcommon.maybe_scan(
        tcfg, jbody, torch.tensor(1.0),
        {"a": torch.from_numpy(xs["a"]),
         "b": tuple(torch.from_numpy(v) for v in xs["b"])})
    assert float(tc) == float(jc)
    np.testing.assert_array_equal(tys["y"].numpy(), np.asarray(jys["y"]))
    np.testing.assert_array_equal(tys["z"][0].numpy(), np.asarray(jys["z"][0]))
    carry, ys = tcommon.maybe_scan(tcfg, lambda c, x: (c + 1, None), 0, None,
                                   length=3)
    assert (carry, ys) == (3, None)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b",
                                  "zamba2-7b", "seamless-m4t-medium"])
def test_abstract_trees_match_reference(arch):
    """``abstract_params`` (meta tensors) and ``abstract_state`` have the
    reference's paths, shapes and dtypes; ``param_axes`` and
    ``state_axes`` its logical axes; nothing is allocated."""
    jcfg = jconfigs.get_config(arch)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))

    def jflat(tree, leaf):
        return {"/".join(str(getattr(k, "key", k)) for k in p): leaf(v)
                for p, v in jax.tree_util.tree_leaves_with_path(
                    tree, is_leaf=lambda x: isinstance(x, tuple))}

    def tflat(tree, prefix=""):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out.update(tflat(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = v
        return out

    shape = lambda v: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    want = jflat(jstep.abstract_state(jcfg),
                 lambda v: (tuple(v.shape), str(v.dtype)))
    got = {k: shape(v) for k, v in tflat(tstep.abstract_state(tcfg)).items()}
    assert got == want
    assert all(v.device.type == "meta"
               for _, v in tree_leaves(tapi.abstract_params(tcfg)))
    jaxes = jflat(jstep.state_axes(jcfg), lambda v: tuple(v))
    taxes = tflat(tstep.state_axes(tcfg))
    assert {k: tuple(v) for k, v in taxes.items()} == jaxes
    assert tflat(tapi.param_axes(tcfg)) == {
        k: v for k, v in jflat(japi.param_axes(jcfg), tuple).items()}
