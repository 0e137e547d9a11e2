"""The Hex path's two fused kernels, held on the CPU: the descent
(``ops.select_descent``: a whole selection round) and the playout
(``ops.hex_playout``: fill + winner).

On the CPU both dispatch points run their plain versions, which must equal
the JAX package (``select_batch``, ``playout_batch``) field by field. The
kernels themselves run only on the card (``chip_smoke.py`` holds them
against the plain versions there); here their arithmetic is mirrored in
numpy in the kernels' own order — the uint32 threefry of
``csrc/threefry.cuh``, the descent kernel's per-lane walk and the playout
kernel's per-cell rank count — and the mirrors are held against the JAX
package and the port's plain versions on the same inputs. Everything
compared is integer- or bool-valued, or a pick, so every comparison is
equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gscpm as jg
from repro.core import hex as jhx
from repro_torch import convert, parity, rng
from repro_torch.core import gscpm as tg
from repro_torch.core import hex as thx
from repro_torch.kernels import _build
from repro_torch.kernels import hex_playout as thp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import select_descent as tsd
from torch_parity_util import both_configs, jax_keys, tree_to_jax

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)


# ------------------------------------------ csrc/threefry.cuh, in numpy ----
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def np_threefry(k0, k1, x0, x1):
    """threefry::block on uint32 arrays, statement by statement."""
    u32 = lambda v: np.asarray(v, dtype=np.uint32)
    k0, k1, x0, x1 = map(u32, (k0, k1, x0, x1))
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for g in range(5):
            for r in ROTATIONS[g % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def np_fold_in(key, d):
    """threefry::fold_in: threefry(k, (0, d))."""
    return np_threefry(key[0], key[1], np.zeros_like(np.asarray(d, np.uint32)),
                       np.asarray(d, np.uint32))


def np_uniform(key, j):
    """threefry::uniform: bitcast((o0 ^ o1) >> 9 | 0x3F800000) - 1."""
    j = np.asarray(j, np.uint32)
    o0, o1 = np_threefry(key[0], key[1], np.zeros_like(j), j)
    bits = ((o0 ^ o1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_threefry_mirror_matches_rng(seed):
    keys = rng.split(rng.key(seed, "cpu"), 16)                    # (16, 2)
    data = np.random.default_rng(seed).integers(0, 2**32, 16, dtype=np.uint64)
    want = rng.fold_in(keys, torch.from_numpy(data.astype(np.int64)))
    kw = keys.numpy().astype(np.uint32)
    got = np.stack(np_fold_in((kw[:, 0], kw[:, 1]), data.astype(np.uint32)),
                   axis=-1)
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())
    # uniform(k, n)[j] is element j of the stream, for every key
    u = rng.uniform(keys, 121).numpy()
    mirror = np_uniform((kw[:, 0:1], kw[:, 1:2]), np.arange(121)[None, :])
    np.testing.assert_array_equal(mirror.view(np.int32), u.view(np.int32))
    # and as the descent uses them: fold_in by depth, then the slot's draw
    level = np_fold_in((kw[:, 0], kw[:, 1]), np.full(16, 3, np.uint32))
    np.testing.assert_array_equal(
        np_uniform((level[0][:, None], level[1][:, None]),
                   np.arange(25)[None, :]).view(np.int32),
        rng.uniform(rng.fold_in(keys, 3), 25).numpy().view(np.int32))


# ------------------------------- the descent kernel's walk, in numpy ----
def np_uct_score(wins, visits, vloss, log_np, cp, noise):
    """uct_score of csrc/uct_select.cu, in float32, in its order."""
    f = np.float32
    n_j = f(visits) + f(vloss)
    d = max(n_j, f(1.0))
    s = (f(wins) / d + f(cp) * np.sqrt(log_np / d)) + noise
    return f(1e30) + noise if n_j <= f(0.0) else s


def descent_mirror(tree, root_board, keys, cp, scale, max_depth):
    """select_descent_kernel lane by lane: walk from the root while the node
    is fully expanded and the depth cap allows, score the valid slots with
    noise ``f32(scale) * uniform(fold_in(key, depth), j)``, keep the first
    maximum, place the child's move. Returns the five outputs."""
    t = convert.tree_to_numpy(tree)
    cap = t["parent"].shape[0] - 1
    C = t["children"].shape[1]
    board0 = root_board.numpy()
    n = board0.size
    kw = keys.numpy().astype(np.uint32)
    W = kw.shape[0]
    paths = np.full((W, max_depth), cap, np.int32)
    paths[:, 0] = 0
    depths, leaves, n_empty = (np.zeros(W, np.int32) for _ in range(3))
    boards = np.zeros((W, n), np.int8)
    for w in range(W):
        board = board0.copy()
        empties = int((board == 0).sum())
        node = depth = 0
        while (t["n_children"][node] == empties and empties != 0
               and depth < max_depth - 2):
            log_np = np.log(max(np.float32(t["visits"][node] +
                                           t["vloss"][node]), np.float32(1)))
            kids = t["children"][node, :min(t["n_children"][node], C)]
            if scale > 0.0:
                lk = np_fold_in((kw[w, 0], kw[w, 1]), depth)
                noise = np.float32(scale) * np_uniform(lk, np.arange(len(kids)))
            else:
                noise = np.zeros(len(kids), np.float32)
            best, best_j = -np.inf, None
            for j, c in enumerate(kids):
                s = np_uct_score(t["wins"][c], t["visits"][c], t["vloss"][c],
                                 log_np, cp, noise[j])
                if s > best:
                    best, best_j = s, j
            child = kids[best_j]
            board[t["move"][child]] = t["to_move"][node]
            depth += 1
            paths[w, depth] = child
            node, empties = child, empties - 1
        depths[w], leaves[w], n_empty[w], boards[w] = depth, node, empties, board
    return paths, depths, leaves, boards, n_empty


def partly_filled(size, empties, seed):
    """A board with only ``empties`` empty cells, stones alternating over a
    seeded random order of the others."""
    n = size * size
    order = np.random.default_rng(seed).permutation(n)
    board = np.zeros(n, np.int8)
    board[order[empties:]] = 1 + np.arange(n - empties) % 2
    return board


@pytest.fixture(scope="module")
def searched_trees():
    """Trees grown by the JAX package's search (5x5 at W = 8, 7x7 at
    W = 16), carried over to the port as numpy."""
    out = {}
    for size, W, playouts in ((5, 8, 512), (7, 16, 1024)):
        _, jcfg = both_configs(board_size=size, n_workers=W, n_tasks=4 * W,
                               n_playouts=playouts, tree_cap=2048)
        jtree, _ = jg.gscpm_search(jnp.zeros(size * size, jnp.int8), 1, jcfg,
                                   jax.random.key(size))
        fields = {k: np.asarray(getattr(jtree, k)) for k in jtree._fields}
        out[size] = (convert.tree_from_numpy(fields, "cpu"),
                     np.zeros(size * size, np.int8), W)
    return out


def descent_case(name, searched_trees):
    """(tree, root board, lanes) of a named case."""
    if name.startswith("search"):
        size = int(name[-1])
        tree, board, W = searched_trees[size]
        tree = parity.clone_tree(tree)
        if name.startswith("search+vloss"):
            # the second round of vl_rounds = 2 sees virtual loss on the tree
            g = torch.Generator().manual_seed(size)
            tree.vloss.copy_(torch.randint(0, 3, tree.vloss.shape, generator=g)
                             .float())
            tree.vloss[tree.cap] = 0.0
        return tree, board, W
    size, empties, levels = {"equal5": (5, 6, 3), "equal7": (7, 5, 4),
                             "equal2": (2, 4, 4), "held5": (5, 6, 3)}[name]
    board = partly_filled(size, empties, seed=size)
    tree = parity.equal_stat_tree(torch.from_numpy(board), levels, 1, 1024,
                                  seed=size)
    if name.startswith("held"):
        tree.n_children[0] -= 1        # the root is one child short
    return tree, board, 8


CASES = ["search5", "search7", "search+vloss5", "equal5", "equal7", "equal2",
         "held5"]


@pytest.mark.parametrize("noise", [0.0, 1e-3])
@pytest.mark.parametrize("name", CASES)
def test_select_descent_matches_jax_select_batch(name, noise, searched_trees):
    """ops.select_descent on CPU tensors, the JAX package's select_batch and
    the numpy mirror of the kernel's walk: all five outputs equal."""
    tree, board, W = descent_case(name, searched_trees)
    game = thx.HexGame(int(board.size ** 0.5))
    keys = rng.split(rng.key(len(name) + int(noise * 1e4), "cpu"), W)
    before = tsd.select_descent.launches
    got = tops.select_descent(tree, torch.from_numpy(board), game, 1.0, keys,
                              noise)
    assert tsd.select_descent.launches == before      # no launch on the CPU
    want = jg.select_batch(tree_to_jax(tree), jnp.asarray(board),
                           jhx.HexGame(game.size), jnp.float32(1.0),
                           jax_keys(keys), noise)
    mirror = descent_mirror(tree, torch.from_numpy(board), keys, 1.0, noise,
                            game.max_moves + 1)
    for g, w, m in zip(got, want, mirror):
        assert g.numpy().dtype == np.asarray(w).dtype == m.dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(m, np.asarray(w))
    depths = got[1].numpy()
    if name.startswith("held"):
        assert (depths == 0).all()
    elif name == "equal2":
        assert (depths == 3).all()                   # the depth cap: n - 1
    elif name.startswith("equal"):
        assert (depths > 0).all()
    assert got[0][:, 0].eq(0).all()


@pytest.mark.parametrize("name", ["equal5", "equal7"])
def test_noise_decides_every_pick_on_equal_stat_trees(name, searched_trees):
    """Siblings that score alike: without noise every lane takes slot 0 at
    every level (the first-index rule); with noise the lanes spread, so a
    wrong in-kernel draw could not pass unseen."""
    tree, board, W = descent_case(name, searched_trees)
    game = thx.HexGame(int(board.size ** 0.5))
    keys = rng.split(rng.key(3, "cpu"), W)
    b = torch.from_numpy(board)
    quiet = tops.select_descent(tree, b, game, 1.0, keys, 0.0)[0]
    first = tree.children[0, 0]
    assert (quiet[:, 1] == first).all()
    noisy = tops.select_descent(tree, b, game, 1.0, keys, 1e-3)[0]
    assert len({tuple(p) for p in noisy.tolist()}) > W // 2


def test_first_divergent_descent_finds_an_injected_difference(
        searched_trees, monkeypatch):
    tree, board, W = searched_trees[5]
    tcfg, _ = both_configs(board_size=5, n_workers=W, tree_cap=2048)
    b = torch.from_numpy(board)
    iter_keys = rng.split(rng.key(11, "cpu"), W)
    assert parity.first_divergent_descent(tree, b, tcfg, 1.0, iter_keys) is None
    plain = tops.select_descent

    def other_child_on_lane_2(*args):
        out = [x.clone() for x in plain(*args)]
        kids = tree.children[0, :int(tree.n_children[0])]
        out[0][2, 1] = kids[(kids == out[0][2, 1]).nonzero()[0, 0] - 1]
        return tuple(out)

    monkeypatch.setattr(tops, "select_descent", other_child_on_lane_2)
    found = parity.first_divergent_descent(tree, b, tcfg, 1.0, iter_keys)
    assert found["lane"] == 2 and found["level"] == 0
    assert found["gap"] > 0.0 and not found["excused"]


# ------------------------------------------------------------ the playout ----
def playout_mirror(boards, to_move, keys):
    """hex_playout_kernel's fill, cell by cell: the board's uniforms, each
    empty cell's rank #{empty j : (u_j, j) < (u_i, i)}, colour by parity."""
    W, n = boards.shape
    kw = keys.astype(np.uint32)
    filled = boards.copy()
    for w in range(W):
        u = np_uniform((kw[w, 0], kw[w, 1]), np.arange(n))
        empty = boards[w] == 0
        for i in np.flatnonzero(empty):
            rank = int((empty & ((u < u[i]) | ((u == u[i])
                                               & (np.arange(n) < i)))).sum())
            filled[w, i] = to_move[w] if rank % 2 == 0 else 3 - to_move[w]
    return filled


@pytest.mark.parametrize("size", [2, 5, 7])
def test_hex_playout_matches_jax_and_fill_plus_winner(size):
    W = 12
    r = np.random.default_rng(size)
    stones = r.integers(1, 3, (W, size * size)).astype(np.int8)
    share = np.linspace(0, 1, W)[:, None]          # from full boards to empty
    boards = np.where(r.random(stones.shape) < share, 0, stones).astype(np.int8)
    tm = r.integers(1, 3, W).astype(np.int32)
    jk = jax.random.split(jax.random.key(size), W)
    tk = convert.key_from_data(np.asarray(jax.random.key_data(jk)), "cpu")
    tb, ttm = torch.from_numpy(boards), torch.from_numpy(tm)

    before = thp.hex_playout.launches
    got = tops.hex_playout(tb, ttm, tk, size)
    assert thp.hex_playout.launches == before         # no launch on the CPU
    assert got.dtype == torch.int8 and got.shape == (W,)
    want = np.asarray(jhx.playout_batch(jnp.asarray(boards), jnp.asarray(tm),
                                        jk, jhx.HexSpec(size)))
    np.testing.assert_array_equal(got.numpy(), want)
    spec = thx.HexSpec(size)
    filled = thx.random_fill_batch(tb, ttm, tk, spec)
    assert torch.equal(got, thx.winner_batch(filled, spec))
    assert torch.equal(thx.playout_batch(tb, ttm, tk, spec), got)
    assert torch.equal(tref.hex_playout(tb, ttm, tk, size), got)
    np.testing.assert_array_equal(playout_mirror(boards, tm, tk.numpy()),
                                  filled.numpy())


# --------------------------------------------------------- the wrappers ----
def small_tree():
    board = torch.from_numpy(partly_filled(5, 6, seed=5))
    return parity.equal_stat_tree(board, 2, 1, 64), board


def test_select_descent_wrapper_refuses_what_the_kernel_does_not_take():
    tree, board = small_tree()
    keys = rng.split(rng.key(0, "cpu"), 4)
    call = lambda t=tree, b=board, k=keys, d=26: tsd.select_descent(
        t, b, k, 1.0, 1e-3, d)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(TypeError, match="wins"):
        call(t=tree._replace(wins=tree.wins.double()))
    with pytest.raises(TypeError, match="noise_keys"):
        call(k=keys.int())
    with pytest.raises(TypeError, match="root_board"):
        call(b=board.int())
    with pytest.raises(ValueError, match="children must be contiguous"):
        call(t=tree._replace(children=tree.children.t().contiguous().t()))
    with pytest.raises(ValueError, match="noise_keys must be contiguous"):
        call(k=rng.split(keys, 3)[:, 0])
    with pytest.raises(ValueError, match="visits has shape"):
        call(t=tree._replace(visits=tree.visits[:-1]))
    with pytest.raises(ValueError, match="cells outside"):
        call(b=torch.zeros(26 * 26, dtype=torch.int8))
    with pytest.raises(ValueError, match="max_depth"):
        call(d=0)
    assert _build._lib is None
    assert tsd.select_descent_plain is tref.select_descent


def test_hex_playout_wrapper_refuses_what_the_kernel_does_not_take():
    boards = torch.zeros(4, 25, dtype=torch.int8)
    tm = torch.ones(4, dtype=torch.int32)
    keys = rng.split(rng.key(0, "cpu"), 4)
    call = lambda b=boards, t=tm, k=keys, s=5: thp.hex_playout(b, t, k, s)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(TypeError, match="boards"):
        call(b=boards.int())
    with pytest.raises(TypeError, match="to_move"):
        call(t=tm.long())
    with pytest.raises(TypeError, match="keys"):
        call(k=keys.int())
    with pytest.raises(ValueError, match="keys must be contiguous"):
        call(k=rng.split(keys, 3)[:, 0])
    with pytest.raises(ValueError, match="boards must be contiguous"):
        call(b=torch.zeros(25, 4, dtype=torch.int8).t())
    with pytest.raises(ValueError, match="size"):
        call(b=torch.zeros(4, 26 * 26, dtype=torch.int8), s=26)
    with pytest.raises(ValueError, match="boards shape"):
        call(s=4)
    assert _build._lib is None
    assert thp.hex_playout_plain is tref.hex_playout


def test_sync_iteration_dispatches_each_phase_once(monkeypatch):
    """A batched sync iteration calls the descent once per virtual-loss
    round and the playout once, through the two dispatch points."""
    calls = {"select_descent": 0, "hex_playout": 0}
    for name in calls:
        inner = getattr(tops, name)

        def counted(*args, _inner=inner, _name=name):
            calls[_name] += 1
            return _inner(*args)

        monkeypatch.setattr(tops, name, counted)
    cfg = tg.GSCPMConfig(board_size=5, n_workers=8, n_tasks=8, n_playouts=32,
                         vl_rounds=2, tree_cap=256)
    tree, _ = tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1, cfg,
                              rng.key(1, "cpu"), device="cpu")
    assert calls == {"select_descent": 2 * 4, "hex_playout": 4}
    assert float(tree.visits[0]) == 32
