"""The port's gradients against ``jax.grad`` of the JAX package's loss, leaf
by leaf by dotted path, on the same converted weights and numpy batch, for
the reduced twin of every family the reference trains: every leaf the
reference differentiates gets a gradient in the port (none is ``None``),
within 1e-4 of that leaf's largest magnitude (1e-3 on the xLSTM twin, whose
exponential gates carry float32 rounding further, as for its logits).
``torch_train_util.ZERO_FLOOR`` says why each leaf's scale has a floor."""

import jax
import numpy as np
import pytest
import torch
from torch_train_util import (FAMILIES, TOL, TOL_XLSTM, assert_trees_close,
                              batch, family_pair, flat_jax, to_jax, to_torch)

from repro.models import api as japi
from repro_torch.models import api as tapi
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)


def port_grads(tp, tcfg, b) -> tuple[float, dict]:
    leaves = tree_leaves(tp.tree())
    loss = tapi.loss(tp, tcfg, to_torch(b))
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True)
    return float(loss.detach()), {
        path: None if g is None else g.float().numpy()
        for (path, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_grads_match_jax_grad(family):
    jcfg, jp, tcfg, tp = family_pair(family, seed=5, requires_grad=True)
    b = batch(jcfg, zero_mask=True)
    want_loss, want = jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, to_jax(b)))(jp)
    loss, got = port_grads(tp, tcfg, b)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert_trees_close(got, flat_jax(want),
                       TOL_XLSTM if family == "xlstm" else TOL, family)
