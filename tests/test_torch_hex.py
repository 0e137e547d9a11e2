"""Port Hex engine == repro.core.hex on the same inputs: everything here is
integer- or bool-valued, so every comparison is equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import game as jgame
from repro.core import hex as jhx
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import game as tgame
from repro_torch.core import hex as thx
from repro_torch.kernels import hex_winner as thw
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

SIZES = [2, 3, 5, 7]


def random_boards(seed, size, W, fill):
    r = np.random.default_rng(seed)
    n = size * size
    b = np.zeros((W, n), np.int8)
    m = r.random((W, n)) < fill
    b[m] = r.integers(1, 3, m.sum())
    return b


def keys_both(seed, W):
    jk = jax.random.split(jax.random.key(seed), W)
    return jk, convert.key_from_data(np.asarray(jax.random.key_data(jk)), "cpu")


def adversarial_stones(size: int) -> np.ndarray:
    """Solid board, column comb, boustrophedon snake: the long thin
    components that need the most pointer-doubling rounds."""
    n = size * size
    solid = np.ones(n, dtype=bool)
    comb = np.zeros(n, dtype=bool)
    snake = np.zeros(n, dtype=bool)
    for r in range(size):
        for c in range(size):
            if c % 2 == 0 or r == 0:
                comb[r * size + c] = True
        for c in (range(size) if r % 2 == 0 else [size - 1]):
            snake[r * size + c] = True
    return np.stack([solid, comb, snake])


@pytest.mark.parametrize("size", SIZES + [11])
def test_static_tables_match(size):
    np.testing.assert_array_equal(thx.neighbor_table(size),
                                  jhx.neighbor_table(size))
    for a, b in zip(thx._static_tables(size), jhx._static_tables(size)):
        np.testing.assert_array_equal(a, b)
    (o1, m1), (o2, m2) = thx._shift_tables(size), jhx._shift_tables(size)
    assert o1 == o2
    np.testing.assert_array_equal(m1, m2)
    assert thx.doubling_rounds(size * size) == jhx.doubling_rounds(size * size)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("fill", [0.0, 0.4, 0.9])
def test_empty_fill_ranks_and_random_fill_match(size, fill):
    W = 8
    boards = random_boards(size, size, W, fill)
    jk, tk = keys_both(size * 7 + 1, W)
    tb = torch.from_numpy(boards)
    want = jgame.empty_fill_ranks(jnp.asarray(boards), jk)
    got = tgame.empty_fill_ranks(tb, tk)
    empties = boards == 0
    np.testing.assert_array_equal(got.numpy()[empties],
                                  np.asarray(want)[empties])
    for to_move in (1, 2, np.array([1, 2] * (W // 2), np.int32)):
        w = jhx.random_fill_batch(jnp.asarray(boards), jnp.asarray(to_move),
                                  jk, jhx.HexSpec(size))
        g = thx.random_fill_batch(tb, torch.as_tensor(to_move), tk,
                                  thx.HexSpec(size))
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (g != 0).all()
    one = thx.random_fill(tb[0], 2, tk[0], thx.HexSpec(size))
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jhx.random_fill(
            jnp.asarray(boards[0]), jnp.int32(2), jk[0], jhx.HexSpec(size))))


def test_parity_fill_colors_match():
    ranks = np.arange(24, dtype=np.int32).reshape(4, 6)
    tm = np.array([1, 2, 2, 1], np.int32)
    np.testing.assert_array_equal(
        tgame.parity_fill_colors(torch.from_numpy(ranks),
                                 torch.from_numpy(tm)).numpy(),
        np.asarray(jgame.parity_fill_colors(jnp.asarray(ranks),
                                            jnp.asarray(tm))))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("player", [1, 2])
def test_connected_batch_and_scalar_match(size, player):
    spec_t, spec_j = thx.HexSpec(size), jhx.HexSpec(size)
    boards = np.concatenate([random_boards(size + player, size, 12, f)
                             for f in (0.5, 0.8, 1.0)])
    want = np.asarray(jhx.connected_batch(jnp.asarray(boards), player, spec_j))
    got = thx.connected_batch(torch.from_numpy(boards), player, spec_t)
    np.testing.assert_array_equal(got.numpy(), want)
    # the scalar flood fill, one board and a whole batch at once
    np.testing.assert_array_equal(
        thx.connected(torch.from_numpy(boards), player, spec_t).numpy(), want)
    assert bool(thx.connected(torch.from_numpy(boards[3]), player,
                              spec_t)) == bool(want[3])
    # per-lane players
    pl = np.where(np.arange(len(boards)) % 2 == 0, 1, 2).astype(np.int8)
    np.testing.assert_array_equal(
        thx.connected_batch(torch.from_numpy(boards), torch.from_numpy(pl),
                            spec_t).numpy(),
        np.asarray(jhx.connected_batch(jnp.asarray(boards), jnp.asarray(pl),
                                       spec_j)))


@pytest.mark.parametrize("size", SIZES + [11])
def test_cc_labels_fixed_rounds_match(size):
    """Labels after exactly doubling_rounds(n) rounds == the fixpoint ==
    the JAX package's labels, random and adversarial stones alike."""
    spec_t, spec_j = thx.HexSpec(size), jhx.HexSpec(size)
    stones = np.concatenate([random_boards(size, size, 8, 0.6) == 1,
                             adversarial_stones(size)])
    rounds = thx.doubling_rounds(size * size)
    fix = thx.cc_labels_batch(torch.from_numpy(stones), spec_t)
    capped = thx.cc_labels_batch(torch.from_numpy(stones), spec_t,
                                 rounds=rounds)
    assert fix.dtype == torch.int32
    assert torch.equal(fix, capped)
    np.testing.assert_array_equal(
        fix.numpy(), np.asarray(jhx.cc_labels_batch(jnp.asarray(stones),
                                                    spec_j)))
    one = thx.cc_labels_batch(torch.from_numpy(stones), spec_t, rounds=1)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jhx.cc_labels_batch(jnp.asarray(stones),
                                                    spec_j, rounds=1)))


@pytest.mark.parametrize("size", [17, 25])
def test_fixed_round_budget_adversarial_boards(size):
    spec = thx.HexSpec(size)
    stones = torch.from_numpy(adversarial_stones(size))
    assert torch.equal(
        thx.cc_labels_batch(stones, spec),
        thx.cc_labels_batch(stones, spec,
                            rounds=thx.doubling_rounds(size * size)))


@pytest.mark.parametrize("size", SIZES)
def test_winners_match_every_formulation(size):
    """Plain hex_winner (pointer doubling) == flood batch == scalar winner
    == the JAX package's dispatch, its oracle and its Pallas kernel in
    interpret mode, on filled boards incl. the adversarial ones."""
    spec_t, spec_j = thx.HexSpec(size), jhx.HexSpec(size)
    adv = np.where(adversarial_stones(size), 1, 2).astype(np.int8)
    boards = np.concatenate([
        random_boards(size, size, 16, 1.1), adv, 3 - adv[:1]])
    assert (boards != 0).all()
    tb, jb = torch.from_numpy(boards), jnp.asarray(boards)
    plain = tref.hex_winner(tb, size)
    assert plain.dtype == torch.int8
    want = np.asarray(jops.hex_winner(jb, size, interpret=True))
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(),
                                  np.asarray(jops.hex_winner(jb, size)))
    for other in (thx.winner_flood_batch(tb, spec_t),
                  thx.winner_batch(tb, spec_t), thx.winner(tb, spec_t),
                  tops.hex_winner(tb, size),
                  torch.stack([thx.winner_checked(b, spec_t) for b in tb])):
        assert other.dtype == torch.int8
        assert torch.equal(plain, other)
    assert plain[-4:].tolist() == [1, 1, 1, 2]   # solid/comb/snake; all-white


@pytest.mark.parametrize("size", SIZES)
def test_playout_batch_matches_under_same_keys(size):
    W = 8
    spec_t, spec_j = thx.HexSpec(size), jhx.HexSpec(size)
    boards = random_boards(size + 3, size, W, 0.3)
    jk, tk = keys_both(size, W)
    tm = np.array([1, 2] * (W // 2), np.int32)
    want = np.asarray(jhx.playout_batch(jnp.asarray(boards), jnp.asarray(tm),
                                        jk, spec_j))
    got = thx.playout_batch(torch.from_numpy(boards), torch.from_numpy(tm),
                            tk, spec_t)
    np.testing.assert_array_equal(got.numpy(), want)
    game = thx.HexGame(size)
    scalar = torch.stack([game.playout_scalar(
        torch.from_numpy(boards[w]), int(tm[w]), tk[w]) for w in range(W)])
    assert torch.equal(scalar, got)
    assert int(thx.playout(torch.from_numpy(boards[0]), 1, tk[0], spec_t)) \
        == int(jhx.playout(jnp.asarray(boards[0]), jnp.int32(1), jk[0], spec_j))
    v = thx.playout_value(torch.from_numpy(boards[0]), 1, 2, tk[0], spec_t)
    assert float(v) == float(jhx.playout_value(
        jnp.asarray(boards[0]), jnp.int32(1), jnp.int32(2), jk[0], spec_j))


def test_place_legal_replay_probe_match():
    size = 5
    game_t, game_j = thx.HexGame(size), jhx.HexGame(size)
    assert (game_t.n_cells, game_t.n_actions, game_t.max_moves) == (
        game_j.n_cells, game_j.n_actions, game_j.max_moves)
    b = random_boards(1, size, 4, 0.4)
    mv = np.array([0, 7, 24, 3], np.int32)
    pl = np.array([1, 2, 1, 2], np.int32)
    got = game_t.place(torch.from_numpy(b), torch.from_numpy(mv),
                       torch.from_numpy(pl))
    want = jax.vmap(game_j.place)(jnp.asarray(b), jnp.asarray(mv),
                                  jnp.asarray(pl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = game_t.place(torch.from_numpy(b[0]), 7, 2)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(game_j.place(jnp.asarray(b[0]), 7,
                                             jnp.int8(2))))
    np.testing.assert_array_equal(
        game_t.legal_mask(torch.from_numpy(b)).numpy(),
        np.asarray(game_j.legal_mask(jnp.asarray(b))))
    np.testing.assert_array_equal(
        game_t.terminal_batch(torch.from_numpy(b)).numpy(),
        np.asarray(game_j.terminal_batch(jnp.asarray(b))))
    moves = np.array([3, 9, 1, 20, 0, 0, 0, 0], np.int32)
    np.testing.assert_array_equal(
        game_t.replay_moves(torch.from_numpy(moves), 4, 2).numpy(),
        np.asarray(game_j.replay_moves(jnp.asarray(moves), jnp.int32(4), 2)))
    for board in (b[0], np.ones(25, np.int8), np.full(25, 2, np.int8)):
        assert int(game_t.winner_probe(torch.from_numpy(board))) == int(
            game_j.winner_probe(jnp.asarray(board)))
    with pytest.raises(AssertionError):
        thx.winner_checked(torch.from_numpy(b[0]), thx.HexSpec(size))


def test_registry_and_kernel_wrapper_contract():
    assert tgame.available_games() == ("gomoku", "hex")
    g = tgame.make_game("hex", 7)
    assert g == thx.HexGame(7) and g != thx.HexSpec(7)
    assert hash(g) == hash(thx.HexGame(7))
    # two games of one size are different games (hash-by-type stamp)
    gm = tgame.make_game("gomoku", 7)
    assert gm != g and gm == tgame.make_game("gomoku", 7)
    assert hash(gm) != hash(g) and len({g, gm}) == 2
    with pytest.raises(ValueError):
        tgame.make_game("chess", 8)
    boards = torch.ones((4, 25), dtype=torch.int8)
    before = thw.hex_winner.launches
    assert tops.hex_winner(boards, 5).tolist() == [1] * 4
    assert thw.hex_winner.launches == before      # no launch counted on CPU
    with pytest.raises(ValueError, match="CUDA"):
        thw.hex_winner(boards, 5)
    assert thw.hex_winner_plain is tref.hex_winner
