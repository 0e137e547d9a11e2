"""The NumPy reference against the port's plain search on the CPU: at a small
board, the same trees and best moves bit for bit."""

import numpy as np
import pytest
import torch

from mctsbench.reference import games, search, threefry
from repro_torch import rng
from repro_torch.core.gscpm import GSCPMConfig
from repro_torch.core.root_parallel import gscpm_search_batch


def test_threefry_equals_the_programs():
    k = np.array([[123, 4567], [0xFFFFFFFF, 9]], dtype=np.uint32)
    kt = torch.tensor(k.astype(np.int64))
    assert np.array_equal(threefry.fold_in(k, [77, 2**32 - 1]),
                          rng.fold_in(kt, torch.tensor([77, 2**32 - 1]))
                          .numpy().astype(np.uint32))
    assert np.array_equal(threefry.split(k, 3),
                          rng.split(kt, 3).numpy().astype(np.uint32))
    assert np.array_equal(threefry.uniform(k, 50), rng.uniform(kt, 50).numpy())


def openings(size, E, seed):
    r = np.random.default_rng(seed)
    boards = np.zeros((E, size * size), np.int8)
    to_move = np.ones(E, np.int32)
    for e in range(E):
        p = int(r.integers(0, 6))
        cells = r.permutation(size * size)[:p]
        boards[e, cells] = np.where(np.arange(p) % 2 == 0, 1, 2)
        to_move[e] = 1 + p % 2
    return boards, to_move


@pytest.mark.parametrize("game,size,E,W,P,T", [
    ("hex", 5, 3, 8, 256, 32), ("hex", 7, 2, 16, 512, 64),
    ("gomoku", 7, 3, 8, 256, 32), ("gomoku", 9, 2, 16, 512, 32)])
def test_reference_equals_the_port_on_the_cpu(game, size, E, W, P, T):
    cfg = dict(game=game, board_size=size, n_workers=W, cp=1.0,
               select_noise=1e-3, tree_cap=1024, vl_rounds=1,
               scheduler="fifo")
    boards, to_move = openings(size, E, size * 100 + E)
    key = np.array([size, 1000 + W], np.uint32)
    forest, stats = gscpm_search_batch(
        torch.tensor(boards), torch.tensor(to_move),
        GSCPMConfig(game=game, board_size=size, n_playouts=P, n_tasks=T,
                    n_workers=W, tree_cap=1024),
        torch.tensor(key.astype(np.int64)), device="cpu")
    want = search.search_members(games.make(game, size), cfg, P, T, boards,
                                 to_move, threefry.fold_in(key, np.arange(E)))
    for e, a in enumerate(want):
        nn = a["n_nodes"]
        assert nn == stats["tree_nodes"][e] > 1
        assert a["best_move"] == stats["member_best_moves"][e]
        for f in ("parent", "move", "visits", "wins"):
            assert np.array_equal(a[f], getattr(forest, f)[e, :nn].numpy()), f


@pytest.mark.parametrize("game,size", [("hex", 11), ("gomoku", 15),
                                       ("gomoku", 9)])
def test_playouts_equal_the_ports(game, size):
    from repro_torch.core.game import make_game
    r = np.random.default_rng(size)
    L, n = 64, size * size
    boards, to_move = openings(size, L, 7)
    keys = r.integers(0, 2**32, size=(L, 2), dtype=np.uint64).astype(np.uint32)
    want = make_game(game, size).playout_batch(
        torch.tensor(boards), torch.tensor(to_move),
        torch.tensor(keys.astype(np.int64)))
    got = games.make(game, size).playout(boards, to_move, keys)
    assert np.array_equal(got, want.numpy())


def test_hex_sides_and_a_full_board_winner():
    g = games.make("hex", 3)
    b = np.array([[1, 0, 0, 1, 0, 0, 1, 0, 0],      # column of 1s
                  [2, 2, 2, 0, 0, 0, 0, 0, 0],      # row of 2s
                  [0, 1, 0, 1, 0, 0, 0, 0, 0]], np.int8)
    assert g.joins_rows(b).tolist() == [True, False, False]
    assert g.has_winner(b).tolist() == [True, True, False]
    # (0,1) touches (1,0): the rhombus's diagonal; (0,0)-(1,1) do not touch
    assert g.joins_rows(np.array([[0, 1, 0, 1, 0, 0, 1, 0, 0]], np.int8))[0]
    assert not g.joins_rows(np.array([[1, 0, 0, 0, 1, 0, 0, 0, 1]],
                                     np.int8))[0]


def test_card_log_matches_correct_log_on_the_cpu():
    x = np.arange(1, 4096, dtype=np.float32)
    assert np.array_equal(search.card_log("cpu")(x), search.correct_log(x))


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.01171875, 3.0e-3, -2.5], np.float32)
    got = search.to_bfloat16(x)
    assert got.tolist() == [1.0, 1.0, 1.015625, 0.0030059814453125, -2.5]


def test_reference_in_worker_processes_equals_one_process():
    from mctsbench.reference import compare
    cfg = dict(game="hex", board_size=5, n_workers=8, cp=1.0,
               select_noise=1e-3, tree_cap=512, vl_rounds=1,
               scheduler="fifo")
    boards, to_move = openings(5, 3, 11)
    keys = threefry.fold_in(np.array([9, 2**31 + 1], np.uint32), np.arange(3))
    log = search.card_log("cpu", upto=4096)
    args = (games.make("hex", 5), cfg, 256, 32, boards, to_move, keys)
    one = search.search_members(*args, log=log)
    two = search.search_members(*args, log=log, workers=2)
    checks, notes = compare.judge(two, one)
    assert checks["parted_members"]["value"] == 0 and not notes
    assert len(two) == 3


def test_log_table_takes_counts_only():
    log = search.card_log("cpu", upto=16)
    assert np.array_equal(log(np.array([1.0, 16.0], np.float32)),
                          search.correct_log(np.array([1.0, 16.0])))
    for bad in ([1.5], [0.0], [17.0]):
        with pytest.raises(ValueError):
            log(np.array(bad, np.float32))
