"""repro_torch.rng == jax.random, bit for bit (typed keys, partitionable
threefry): key, fold_in, split, uniform, batched, several seeds."""

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert, rng

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def words(jkey):
    """uint32 key words of a typed JAX key (batch) as int64, the port's
    storage type."""
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(rng.key(seed, "cpu").numpy(),
                                  words(jax.random.key(seed)))


def test_pinned_vectors():
    """The constants chip_smoke.py checks on the GPU."""
    assert rng.fold_in(rng.key(0, "cpu"), 3).tolist() == [2467461003, 3840466878]
    k7 = jax.random.key(7)
    assert rng.split(rng.key(7, "cpu"), 3).tolist() == words(
        jax.random.split(k7, 3)).tolist() == [[3625411723, 1954958720],
                                              [195045567, 4062205631],
                                              [966301609, 1948237315]]
    u = rng.uniform(rng.key(7, "cpu"), 4)
    assert u.view(torch.int32).tolist() == np.asarray(
        jax.random.uniform(k7, (4,))).view(np.int32).tolist() == [
            1059885352, 1064927358, 1050349136, 1055084168]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 3, 121, 65535, 2**31 - 1])
def test_fold_in_matches_jax(seed, data):
    got = rng.fold_in(rng.key(seed, "cpu"), data)
    np.testing.assert_array_equal(
        got.numpy(), words(jax.random.fold_in(jax.random.key(seed), data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 16, 256])
def test_split_matches_jax(seed, n):
    got = rng.split(rng.key(seed, "cpu"), n)
    assert got.shape == (n, 2) and got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), words(jax.random.split(jax.random.key(seed), n)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 5, 25, 49, 121])
def test_uniform_matches_jax(seed, n):
    got = rng.uniform(rng.key(seed, "cpu"), n)
    assert got.dtype == torch.float32
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (n,)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_batched_chain_matches_jax_vmap(seed):
    """The search's own pattern: split per lane, fold a per-lane depth in,
    draw a row of uniforms — batched over leading axes."""
    W, C = 8, 25
    jkeys = jax.random.split(jax.random.key(seed), W)
    tkeys = convert.key_from_data(np.asarray(jax.random.key_data(jkeys)), "cpu")
    np.testing.assert_array_equal(tkeys.numpy(), words(jkeys))
    depths = np.random.default_rng(seed).integers(0, 30, W).astype(np.int32)

    j3 = jax.vmap(lambda k: jax.random.split(k, 3))(jkeys)
    t3 = rng.split(tkeys, 3)
    assert t3.shape == (W, 3, 2)
    np.testing.assert_array_equal(t3.numpy(), words(j3))

    want = jax.vmap(lambda k, d: jax.random.uniform(
        jax.random.fold_in(k, d), (C,)))(j3[:, 0], depths)
    got = rng.uniform(rng.fold_in(t3[:, 0], torch.from_numpy(depths)), C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # key against a vector of ids: fold_task_keys' broadcast
    ids = np.arange(5, dtype=np.int32) * 7
    want = jax.vmap(lambda t: jax.random.fold_in(jax.random.key(seed), t))(ids)
    got = rng.fold_in(rng.key(seed, "cpu"), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), words(want))


def test_key_from_data_round_trip():
    data = np.array([[4294967295, 0], [1, 2147483648]], dtype=np.uint32)
    k = convert.key_from_data(data, "cpu")
    assert k.dtype == torch.int64 and k.tolist() == data.tolist()
    with pytest.raises(ValueError):
        convert.key_from_data(np.zeros(3, np.uint32), "cpu")
