"""The traffic generator: the same seed gives the same positions, every call
the same work, and every opening is legal."""

import numpy as np
import pytest

from mctsbench.manifest import ROOT, Manifest
from mctsbench.reference import games, threefry

CELLS = ("hex11.moves_b1024", "gomoku15.moves_b256")


def closed_batch():
    return Manifest(ROOT).module("traffic", "closed_batch")


def make(cell, seed, man=Manifest(ROOT)):
    w = man.cell(cell)
    config = man.config(w["config"])
    params = man.workload_params(cell)
    traffic = man.module("traffic", params["kind"]).Traffic(params, config,
                                                            seed)
    return traffic, traffic.game, params


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_positions(cell):
    a, _, _ = make(cell, 2**31 + 77)
    b, _, _ = make(cell, 2**31 + 77)
    c, _, _ = make(cell, 2**31 + 78)
    assert np.array_equal(a.boards, b.boards)
    assert np.array_equal(a.to_move, b.to_move)
    assert not np.array_equal(a.boards, c.boards)
    for i in (-1, 0, 5, 40):
        for x, y in zip(a.call(i), b.call(i)):
            assert np.array_equal(x, y)
    assert not np.array_equal(a.call_key(0), c.call_key(0))
    assert not np.array_equal(a.call_key(0), a.call_key(1))
    assert not np.array_equal(a.call_key(-1), a.call_key(0))


@pytest.mark.parametrize("cell", CELLS)
def test_openings_legal_and_alike_in_size(cell):
    t, game, params = make(cell, 12345)
    lo, hi = params["opening_plies"]
    blocks = closed_batch().BLOCKS
    assert t.boards.shape == (blocks, params["members"], game.n_cells)
    stones = (t.boards != 0).sum(axis=2)
    ones, twos = (t.boards == 1).sum(axis=2), (t.boards == 2).sum(axis=2)
    assert stones.min() >= lo and stones.max() <= hi
    # player 1 first, alternating; the side to move follows the last ply
    assert np.all((ones == twos) | (ones == twos + 1))
    assert np.array_equal(t.to_move, np.where(ones == twos, 1, 2))
    # every block (every call) asks for the same multiset of lengths
    for b in range(1, blocks):
        assert np.array_equal(np.sort(stones[b]), np.sort(stones[0]))
    assert not game.has_winner(t.boards.reshape(-1, game.n_cells)).any()


def test_gomoku_openings_with_a_five_are_drawn_again():
    openings = closed_batch().openings
    game = games.make("gomoku", 5)
    plies = np.full(200, 16)
    boards, _ = openings(game, plies, np.random.default_rng(0))
    assert not game.has_winner(boards).any()
    assert ((boards != 0).sum(axis=1) == 16).all()


def test_keys_from_large_seeds():
    k = threefry.key_from_seed(2**40 + 5)
    assert k.tolist() == [256, 5]
    with pytest.raises(ValueError):
        threefry.key_from_seed(-1)
