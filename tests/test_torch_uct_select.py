"""The port's plain uct_select vs the JAX package's oracle and its Pallas
kernel in interpret mode, on the same numpy inputs.

UCT scores are the one float-valued decision of the search: ``log``,
``sqrt`` and divide may round differently in XLA:CPU and in PyTorch, so with
tie-break noise picks are required to be equal wherever the reference's two
best scores are more than 1e-6 apart (the count of rows below that is
reported); without noise, on integer-valued stats, they are equal
everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import uct as juct
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import parity
from repro_torch.core import uct as tuct
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import uct_select as tus

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

SHAPES = [(7, 11), (64, 121), (16, 8), (1, 5), (13, 1)]


def case(W, C, noise, mask, seed):
    """Integer-valued stats with unvisited slots, invalid slots (random and
    tails) and a fully masked row."""
    r = np.random.default_rng(seed)
    visits = np.round(r.random((W, C)) * 10).astype(np.float32)
    wins = np.round(r.random((W, C)) * visits).astype(np.float32)
    vloss = (np.round(r.random((W, C)) * 2) * (r.random((W, C)) < 0.3)
             ).astype(np.float32)
    valid = r.random((W, C)) > 0.3
    valid[::2] = np.arange(C)[None, :] < r.integers(0, C + 1, (W, 1))[::2]
    ptot = np.maximum((visits * valid).sum(-1), 1.0).astype(np.float32)
    nz = (1e-3 * r.random((W, C))).astype(np.float32) if noise else None
    lm = None
    if mask:
        lm = r.random(W) > 0.25
        lm[W // 2] = False
    return (wins, visits, vloss, ptot, valid), nz, lm


def j(x):
    return None if x is None else jnp.asarray(x)


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def reference_gap(args, cp, nz, lm):
    """Top-two gap of the REFERENCE's final scores (the kernel's spelling:
    +-1e30 for unvisited / invalid), per row."""
    wins, visits, vloss, ptot, valid = args
    if lm is not None:
        valid = valid & lm[:, None]
    s = np.asarray(juct.uct_scores(j(wins), j(visits), j(vloss), j(ptot),
                                   jnp.float32(cp), j(valid)))
    nzz = np.zeros_like(s) if nz is None else nz
    s = np.where(np.isfinite(s), s + nzz, s)
    s = np.clip(np.where(s == np.inf, np.float32(1e30) + nzz, s), -1e30, 1e30)
    if s.shape[1] < 2:
        return np.full(s.shape[0], np.inf)
    top = -np.sort(-s, axis=1)[:, :2]
    return top[:, 0] - top[:, 1]


@pytest.mark.parametrize("W,C", SHAPES)
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("cp", [1.0, 0.35])
def test_plain_matches_jax_oracle_and_interpreted_kernel(W, C, noise, mask, cp):
    args, nz, lm = case(W, C, noise, mask, seed=W * C + 2 * noise + mask)
    got = tref.uct_select(*map(t, args), cp, noise=t(nz), lane_mask=t(lm))
    assert got.dtype == torch.int32 and got.shape == (W,)
    oracle = np.asarray(jref.uct_select(*map(j, args), jnp.float32(cp),
                                        noise=j(nz), lane_mask=j(lm)))
    kernel = np.asarray(jops.uct_select(*map(j, args), jnp.float32(cp),
                                        noise=j(nz), lane_mask=j(lm),
                                        interpret=True))
    clear = np.ones(W, bool)
    if noise:
        clear = reference_gap(args, cp, nz, lm) > parity.TIE_GAP
        # the port's own gap helper sees the same rows as clear
        pgap = parity.top_two_gap(*map(t, args), cp, noise=t(nz),
                                  lane_mask=t(lm)).numpy()
        assert ((pgap > parity.TIE_GAP) == clear).mean() > 0.95
    print(f"rows below the tie gap: {int((~clear).sum())} of {W}")
    np.testing.assert_array_equal(got.numpy()[clear], oracle[clear])
    np.testing.assert_array_equal(got.numpy()[clear], kernel[clear])
    if lm is not None:       # a masked row deterministically yields slot 0
        assert (got.numpy()[~lm] == 0).all()


@pytest.mark.parametrize("W,C", SHAPES[:3])
@pytest.mark.parametrize("cp", [1.0, 0.35, 1.7])
def test_scores_match_jax_within_float_rounding(W, C, cp):
    """Scores agree to a few float32 ulps (log/sqrt/divide rounding), and
    the inf / -inf structure is identical."""
    args, _, _ = case(W, C, False, False, seed=W + C)
    wins, visits, vloss, ptot, valid = args
    want = np.asarray(juct.uct_scores(j(wins), j(visits), j(vloss), j(ptot),
                                      jnp.float32(cp), j(valid)))
    got = tuct.uct_scores(t(wins), t(visits), t(vloss), t(ptot), cp,
                          t(valid)).numpy()
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)


def test_unvisited_ties_go_to_the_lowest_slot():
    """In float32 1e30 + noise == 1e30: noise cannot break ties among
    unvisited children, both spellings pick the first one. Kept, not
    repaired."""
    W, C = 4, 9
    z = torch.zeros((W, C))
    valid = torch.ones((W, C), dtype=torch.bool)
    valid[:, 0] = False
    nz = 1e-3 * torch.rand((W, C), generator=torch.Generator().manual_seed(0))
    got = tref.uct_select(z, z, z, torch.ones(W), valid, 1.0, noise=nz)
    assert got.tolist() == [1] * W
    want = jref.uct_select(j(z.numpy()), j(z.numpy()), j(z.numpy()),
                           jnp.ones(W), j(valid.numpy()), 1.0,
                           noise=j(nz.numpy()))
    assert np.asarray(want).tolist() == [1] * W
    assert float(torch.tensor(1e30) + nz.max()) == float(torch.tensor(1e30))


def test_dispatch_takes_plain_on_cpu_and_kernel_refuses_cpu():
    args, nz, lm = case(8, 25, True, True, seed=3)
    targs = list(map(t, args))
    before = tus.uct_select.launches
    got = tops.uct_select(*targs, 0.7, noise=t(nz), lane_mask=t(lm))
    want = tref.uct_select(*targs, 0.7, noise=t(nz), lane_mask=t(lm))
    assert torch.equal(got, want)
    assert tus.uct_select.launches == before    # no launch counted on CPU
    with pytest.raises(ValueError, match="CUDA"):
        tus.uct_select(*targs, 0.7, noise=t(nz), lane_mask=t(lm))
    assert tus.uct_select_plain is tref.uct_select


def test_select_child_without_noise_is_first_index_argmax():
    s = torch.tensor([[1.0, 3.0, 3.0, -float("inf")],
                      [float("inf"), 2.0, float("inf"), 0.0]])
    assert tuct.select_child(s).tolist() == [1, 0]
    assert np.asarray(juct.select_child(j(s.numpy()))).tolist() == [1, 0]
