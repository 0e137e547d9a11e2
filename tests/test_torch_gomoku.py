"""Port Gomoku engine == repro.core.gomoku on the same inputs.

Everything here is integer- or bool-valued, so every comparison is
equality: the window tables, the window scans, the terminal and winner
tests, the completion-time outcome, the batched playout (and the port's own
sequential ``playout_scalar``), and whole ``gscpm_search`` trees on 7x7
Gomoku, field by field (``torch_parity_util.assert_same_search``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gomoku as jgm
from repro.core import gscpm as jg
from repro.kernels import ops as jops
from repro_torch import convert, parity, rng
from repro_torch.core import gomoku as tgm
from repro_torch.core import gscpm as tg
from repro_torch.core import tree as tt
from repro_torch.kernels import ops as tops
from torch_parity_util import assert_same_search, assert_trees_equal

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

SIZES = [5, 6, 7, 9]


def random_boards(seed, size, W, fill):
    r = np.random.default_rng(seed)
    n = size * size
    b = np.zeros((W, n), np.int8)
    m = r.random((W, n)) < fill
    b[m] = r.integers(1, 3, m.sum())
    return b


def line_boards(size: int) -> np.ndarray:
    """Adversarial boards: a five along each direction at the board's
    corners and edges, four-runs that would become a five only through a
    roll's wrap-around (row end -> next row start, last column -> first),
    a full checkerboard-of-pairs with no five (a draw), and a board where
    both colors own a five (illegal; evaluates to a draw)."""
    n = size * size
    out = []

    def board(cells, p=1):
        b = np.zeros(n, np.int8)
        for r, c in cells:
            b[r * size + c] = p
        return b

    for r0, c0, dr, dc in ((0, 0, 0, 1), (0, size - 5, 0, 1), (size - 1, 0, 0, 1),
                           (0, 0, 1, 0), (size - 5, size - 1, 1, 0),
                           (0, 0, 1, 1), (size - 5, size - 5, 1, 1),
                           (0, size - 1, 1, -1), (size - 5, 4, 1, -1)):
        out.append(board([(r0 + k * dr, c0 + k * dc) for k in range(5)],
                         p=1 + len(out) % 2))
    # wrap-around traps: 3 at a row's end + 2 at the next row's start, and a
    # diagonal that leaves the board on the right
    out.append(board([(1, size - 3), (1, size - 2), (1, size - 1), (2, 0), (2, 1)]))
    out.append(board([(k, size - 3 + k) for k in range(3)] + [(3, 0), (4, 1)], 2))
    # full board with no five: pairs of stones alternating in a 2x2 motif
    # shifted each row keeps every run at most two long
    full = np.array([1 + ((c // 2) + r) % 2 for r in range(size)
                     for c in range(size)], np.int8)
    out.append(full)
    both = board([(0, k) for k in range(5)])
    both[(size - 1) * size: (size - 1) * size + 5] = 2
    out.append(both)
    return np.stack(out)


def both(b):
    return torch.from_numpy(b), jnp.asarray(b)


@pytest.mark.parametrize("size", SIZES + [15])
def test_window_tables_match(size):
    toffs, tmasks = tgm._window_tables(size)
    joffs, jmasks = jgm._window_tables(size)
    assert toffs == joffs
    np.testing.assert_array_equal(tmasks, jmasks)


@pytest.mark.parametrize("size", SIZES)
def test_window_scans_and_winner_match(size):
    boards = np.concatenate([random_boards(size, size, 64, 0.8),
                             random_boards(size + 100, size, 64, 1.0),
                             line_boards(size)])
    tb, jb = both(boards)
    spec_t, spec_j = tgm.GomokuSpec(size), jgm.GomokuSpec(size)
    for p in (1, 2):
        np.testing.assert_array_equal(
            tgm.five_windows_batch(tb == p, spec_t).numpy(),
            np.asarray(jgm.five_windows_batch(jb == p, spec_j)))
        np.testing.assert_array_equal(
            tgm.has_five_batch(tb, p, spec_t).numpy(),
            np.asarray(jgm.has_five_batch(jb, p, spec_j)))
    np.testing.assert_array_equal(tgm.terminal_batch(tb, spec_t).numpy(),
                                  np.asarray(jgm.terminal_batch(jb, spec_j)))
    want = np.asarray(jgm.winner_scan_batch(jb, spec_j))
    np.testing.assert_array_equal(tgm.winner_scan_batch(tb, spec_t).numpy(), want)
    got = tops.gomoku_winner(tb, size)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.gomoku_winner(jb, size)))
    # the adversarial boards: every line is a five, no trap is, the
    # no-five full board is a draw; of two fives black's is reported
    n_lines = 9
    adv = tgm.winner_scan_batch(torch.from_numpy(line_boards(size)), spec_t)
    assert (adv[:n_lines] > 0).all() and (adv[n_lines:-1] == 0).all()
    assert int(adv[-1]) == 1


@pytest.mark.parametrize("size", SIZES)
def test_first_completion_winner_matches(size):
    r = np.random.default_rng(size)
    n = size * size
    W = 96
    filled = r.integers(1, 3, (W, n)).astype(np.int8)
    pre = r.random((W, n)) < np.linspace(0, 0.6, W)[:, None]
    times = np.argsort(r.random((W, n)), axis=1).argsort(axis=1).astype(np.int32)
    times = np.where(pre, -1, times).astype(np.int32)
    filled = np.concatenate([filled, line_boards(size)])
    times = np.concatenate([times, np.full((len(line_boards(size)), n), -1,
                                           np.int32)])
    tf, jf = both(filled)
    tt_, jt_ = both(times)
    want = np.asarray(jops.gomoku_first_winner(jf, jt_, size))
    got = tops.gomoku_first_winner(tf, tt_, size)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= {0, 1, 2} and (want == 0).any()


@pytest.mark.parametrize("size,fill", [(5, 0.0), (6, 0.3), (7, 0.5), (9, 0.2)])
def test_playout_batch_bit_equal_to_jax_and_to_scalar(size, fill):
    W = 24
    boards = random_boards(7 * size, size, W, fill)
    # no pre-existing five: search leaves never hold one past legal moves
    boards[tgm.terminal_batch(torch.from_numpy(boards),
                              tgm.GomokuSpec(size)).numpy()] = 0
    jk = jax.random.split(jax.random.key(size), W)
    tk = convert.key_from_data(np.asarray(jax.random.key_data(jk)), "cpu")
    to_move = np.random.default_rng(size).integers(1, 3, W).astype(np.int32)
    tb, jb = both(boards)
    spec_t, spec_j = tgm.GomokuSpec(size), jgm.GomokuSpec(size)
    got = tgm.playout_batch(tb, torch.from_numpy(to_move), tk, spec_t)
    want = np.asarray(jgm.playout_batch(jb, jnp.asarray(to_move), jk, spec_j))
    np.testing.assert_array_equal(got.numpy(), want)
    scalar = torch.stack([tgm.playout_scalar(tb[w], int(to_move[w]), tk[w],
                                             spec_t) for w in range(W)])
    np.testing.assert_array_equal(scalar.numpy(), want)
    if size == 5:   # a 5x5 fill ends in a five or a draw: both must occur
        assert {0} < set(want.tolist())


def test_game_protocol_matches():
    tg_, jg_ = tgm.GomokuGame(7), jgm.GomokuGame(7)
    assert (tg_.n_cells, tg_.n_actions, tg_.max_moves) == (
        jg_.n_cells, jg_.n_actions, jg_.max_moves)
    boards = np.concatenate([random_boards(3, 7, 16, 0.6), line_boards(7)])
    for b in boards:
        tb, jb = both(b)
        np.testing.assert_array_equal(tg_.legal_mask(tb).numpy(),
                                      np.asarray(jg_.legal_mask(jb)))
        assert int(tg_.winner_probe(tb)) == int(jg_.winner_probe(jb))
    # legal_mask is batched over leading axes
    tb = torch.from_numpy(boards)
    even = 2 * (len(boards) // 2)
    np.testing.assert_array_equal(
        tg_.legal_mask(tb[:even].view(2, -1, 49)).reshape(-1, 49).numpy(),
        np.stack([np.asarray(jg_.legal_mask(jnp.asarray(b)))
                  for b in boards[:even]]))
    term = boards[tgm.terminal_batch(tb, tgm.GomokuSpec(7)).numpy()]
    np.testing.assert_array_equal(
        tg_.winner_batch(torch.from_numpy(term)).numpy(),
        np.asarray(jg_.winner_batch(jnp.asarray(term))))
    moves = np.array([3, 9, 1, 20, 0, 0, 0, 0], np.int32)
    np.testing.assert_array_equal(
        tg_.replay_moves(torch.from_numpy(moves), 4, 2).numpy(),
        np.asarray(jg_.replay_moves(jnp.asarray(moves), jnp.int32(4), 2)))
    assert tg_.init_board("cpu").shape == (49,)
    np.testing.assert_array_equal(
        tg_.place(torch.zeros(49, dtype=torch.int8), 5, 2).numpy(),
        np.asarray(jg_.place(jnp.zeros(49, jnp.int8), 5, jnp.int8(2))))


def config_kw(W, seed_sched="fifo"):
    return dict(game="gomoku", board_size=7, n_workers=W, tree_cap=2048,
                scheduler=seed_sched, n_playouts=48 if W == 1 else 192,
                n_tasks=4 if W == 1 else 20)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("W", [1, 8])
def test_gomoku_search_tree_equals_reference(W, seed):
    board = np.zeros(49, np.int8)
    tree, stats = assert_same_search(board, 1, config_kw(W), seed)
    tt.check_invariants(tree)
    assert float(tree.visits[0]) == stats["playouts"]


def test_gomoku_search_from_open_four_equals_reference():
    """The position of the JAX package's immediate-win test, at a smaller
    budget: black's open four on row 3, white in the corners."""
    b = np.zeros(49, np.int8)
    b[[22, 23, 24, 25]] = 1
    b[[0, 6, 42, 48]] = 2
    tree, _ = assert_same_search(b, 1, {**config_kw(8), "vl_rounds": 2}, 2)
    tt.check_invariants(tree)


def test_draws_back_up_half_a_win():
    """A 4x4 board cannot hold a five: every playout is a draw, so every
    node's wins are exactly half its visits, in both packages."""
    kw = dict(game="gomoku", board_size=4, n_workers=8, n_tasks=8,
              n_playouts=64, tree_cap=512)
    tree, _ = assert_same_search(np.zeros(16, np.int8), 1, kw, 3)
    n = int(tree.n_nodes)
    assert float(tree.visits[0]) == 64
    assert torch.equal(tree.wins[:n] * 2, tree.visits[:n])


def test_won_position_is_terminal_not_expanded():
    """A position already holding a five has no legal move: the root is
    never expanded, the descent stops at it, and every playout backs up
    the pre-existing winner (credit 0 for the root's mover-into)."""
    b = np.zeros(49, np.int8)
    b[14:19] = 1
    b[[40, 41, 45, 46]] = 2
    cfg = tg.GSCPMConfig(game="gomoku", board_size=7, n_workers=8, n_tasks=8,
                         n_playouts=64, tree_cap=256)
    tree, _ = tg.gscpm_search(torch.from_numpy(b), 2, cfg, rng.key(4, "cpu"),
                              device="cpu")
    jtree, _ = jg.gscpm_search(jnp.asarray(b), 2, jg.GSCPMConfig(
        game="gomoku", board_size=7, n_workers=8, n_tasks=8, n_playouts=64,
        tree_cap=256), jax.random.key(4))
    assert_trees_equal(tree, jtree)
    assert int(tree.n_nodes) == 1 and int(tree.n_children[0]) == 0
    # root to_move 2: black (1) moved into it and won every playout
    assert float(tree.visits[0]) == float(tree.wins[0]) == 64


@pytest.mark.parametrize("seed", [0, 3])
def test_sequential_uct_runs_gomoku_and_equals_reference(seed):
    """``mcts.uct_search`` (the Table II baseline) runs Gomoku through the
    protocol: its tree equals the JAX package's and the single-lane GSCPM
    search's."""
    from repro.core import mcts as jmcts
    from repro_torch.core import mcts as tmcts
    board = np.zeros(49, np.int8)
    tree, st = tmcts.uct_search(torch.from_numpy(board), 1, 64,
                                rng.key(seed, "cpu"), board_size=7,
                                tree_cap=512, game="gomoku", device="cpu")
    jtree, jst = jmcts.uct_search(jnp.asarray(board), 1, 64,
                                  jax.random.key(seed), board_size=7,
                                  tree_cap=512, game="gomoku")
    assert_trees_equal(tree, jtree)
    assert st["best_move"] == jst["best_move"]
    single, _ = tg.gscpm_search(
        torch.from_numpy(board), 1, tg.GSCPMConfig(
            game="gomoku", board_size=7, n_workers=1, n_tasks=1,
            n_playouts=64, tree_cap=512, select_noise=0.0,
            scheduler="sequential"), rng.key(seed, "cpu"), device="cpu")
    assert parity.differing_fields(single, tree) == []


def test_scalar_oracles_equal_the_batched_gomoku_search():
    kw = dict(game="gomoku", board_size=6, n_workers=8, n_tasks=8,
              n_playouts=64, tree_cap=512, vl_rounds=2)
    base, _ = tg.gscpm_search(torch.zeros(36, dtype=torch.int8), 1,
                              tg.GSCPMConfig(**kw), rng.key(8, "cpu"),
                              device="cpu")
    for over in (dict(descent="scalar"), dict(playout="scalar")):
        other, _ = tg.gscpm_search(torch.zeros(36, dtype=torch.int8), 1,
                                   tg.GSCPMConfig(**kw, **over),
                                   rng.key(8, "cpu"), device="cpu")
        assert parity.differing_fields(other, base) == []
    tt.check_invariants(base)
