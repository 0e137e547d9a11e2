"""The move proposal, held on the CPU: ``kernels.ops.propose_move`` (the
dispatch point ``core.gscpm.propose_move`` calls with the game's legal
mask).

On the CPU the dispatch point runs its plain version, which must equal the
JAX package's ``propose_move`` (vmapped over lanes, and over members on a
forest) on mid-search Hex and Gomoku trees, for every leaf shape the port
passes: ``()`` (the scalar oracles, ``core/mcts.py``), ``(W,)`` (a tree)
and ``(E, W)`` (a forest). The kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there); here its
arithmetic is mirrored in numpy in the kernel's own order — the tried-move
bitmask, a draw only for untried legal cells, each of a warp's 32 threads
scanning cells t, t + 32, ... and the butterfly with ties to the lower
cell — and the mirror is held against the plain version. Every comparison
is equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gscpm as jg
from repro_torch import rng
from repro_torch.core import gscpm as tg
from repro_torch.core import root_parallel as trp
from repro_torch.core import tree as tt
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import propose_move as tpm
from repro_torch.kernels import ref as tref
from test_torch_fused_hex import np_uniform
from torch_parity_util import both_configs, jax_keys, tree_to_jax

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

# (game, size, lanes, playouts): mid-search trees grown by the port's own
# search on the CPU (held to the JAX package's by the other parity files)
GAMES = {"hex5": ("hex", 5, 8, 512), "hex7": ("hex", 7, 16, 1024),
         "gomoku9": ("gomoku", 9, 16, 1024)}
E = 3


def configs(name, **kw):
    game, size, W, playouts = GAMES[name]
    return both_configs(game=game, board_size=size, n_workers=W,
                        n_tasks=4 * W, n_playouts=playouts, tree_cap=2048,
                        **kw)


@pytest.fixture(scope="module")
def grown():
    """name -> (single tree, forest of E members, (E, n) member boards)."""
    out = {}
    for i, name in enumerate(GAMES):
        tcfg, _ = configs(name)
        n = tcfg.game_obj.n_cells
        board = torch.zeros(n, dtype=torch.int8)
        tree, _ = tg.gscpm_search(board, 1, tcfg, rng.key(10 + i, "cpu"),
                                  device="cpu")
        # three members from three positions: empty, one and two stones
        boards = torch.zeros((E, n), dtype=torch.int8)
        boards[1, n // 2] = 1
        boards[2, 0], boards[2, n - 1] = 1, 2
        forest, _ = trp.gscpm_search_batch(
            boards, torch.tensor([1, 2, 1]), tcfg, rng.key(20 + i, "cpu"),
            device="cpu")
        out[name] = (tree, forest, boards)
    return out


def round_inputs(tree, boards, game, lead, seed):
    """One selection round's leaves and leaf boards (the descent's plain
    version) and the move keys as the search passes them: a view of a
    (..., 3, 2) split."""
    keys = rng.split(rng.split(rng.key(seed, "cpu"),
                               int(np.prod(lead))), 3).view(*lead, 3, 2)
    _, _, leaves, leaf_boards, _ = tops.select_descent(
        tree, boards, game, 1.0, keys[..., 0, :].contiguous(), 1e-3)
    return leaves, leaf_boards, keys[..., 1, :]


def jax_proposals(tree, leaves, boards, keys, jgame):
    """The JAX package's propose_move, vmapped over lanes (and member by
    member on a forest)."""
    one = lambda jtree: jax.vmap(lambda l, b, k: jg.propose_move(
        jtree, l, b, jgame, k))
    if tree.parent.dim() == 1:
        return np.asarray(one(tree_to_jax(tree))(
            jnp.asarray(leaves.numpy()), jnp.asarray(boards.numpy()),
            jax_keys(keys)))
    return np.stack([np.asarray(one(tree_to_jax(tt.forest_member(tree, e)))(
        jnp.asarray(leaves[e].numpy()), jnp.asarray(boards[e].numpy()),
        jax_keys(keys[e]))) for e in range(tree.parent.shape[0])])


def proposed(tree, leaves, boards, game, keys):
    """ops.propose_move on the game's legal mask, checked to launch nothing
    on the CPU and to equal the public core.gscpm.propose_move."""
    before = tpm.propose_move.launches
    got = tops.propose_move(tree, leaves, game.legal_mask(boards), keys)
    assert tpm.propose_move.launches == before
    assert got.dtype == torch.int32 and got.shape == leaves.shape
    assert torch.equal(tg.propose_move(tree, leaves, boards, game, keys), got)
    return got


@pytest.mark.parametrize("name", list(GAMES))
def test_propose_matches_jax_on_a_tree(name, grown):
    tree, _, _ = grown[name]
    tcfg, jcfg = configs(name)
    game = tcfg.game_obj
    W = tcfg.n_workers
    board = torch.zeros(game.n_cells, dtype=torch.int8)
    leaves, boards, keys = round_inputs(tree, board, game, (W,), 1)
    got = proposed(tree, leaves, boards, game, keys)
    np.testing.assert_array_equal(
        got.numpy(), jax_proposals(tree, leaves, boards, keys,
                                   jcfg.game_obj))
    assert (got >= 0).any()
    # the () leaf of the scalar oracles: lane by lane, the same move
    for w in (0, W - 1):
        one = proposed(tree, leaves[w], boards[w], game, keys[w])
        assert one.shape == () and int(one) == int(got[w])
        want = jg.propose_move(tree_to_jax(tree), jnp.int32(int(leaves[w])),
                               jnp.asarray(boards[w].numpy()), jcfg.game_obj,
                               jax_keys(keys[w]))
        assert int(one) == int(want)


@pytest.mark.parametrize("name", list(GAMES))
def test_propose_matches_jax_on_a_forest(name, grown):
    _, forest, member_boards = grown[name]
    tcfg, jcfg = configs(name)
    game = tcfg.game_obj
    W = tcfg.n_workers
    leaves, boards, keys = round_inputs(forest, member_boards, game, (E, W),
                                        2)
    got = proposed(forest, leaves, boards, game, keys)
    assert got.shape == (E, W)
    np.testing.assert_array_equal(
        got.numpy(), jax_proposals(forest, leaves, boards, keys,
                                   jcfg.game_obj))
    # member e of the forest proposes as the single tree e would
    for e in range(E):
        assert torch.equal(got[e], proposed(
            tt.forest_member(forest, e), leaves[e], boards[e], game, keys[e]))


def filled_board(game, size):
    """A board with no legal move: Hex filled; Gomoku with a five in the
    first row and every other cell empty."""
    n = size * size
    if game == "hex":
        return (1 + torch.arange(n) % 2).to(torch.int8)
    board = torch.zeros(n, dtype=torch.int8)
    board[:5] = 1
    return board


@pytest.mark.parametrize("name", list(GAMES))
def test_terminal_and_fully_tried_leaves_propose_nothing(name, grown):
    tree, forest, member_boards = grown[name]
    tcfg, jcfg = configs(name)
    game, (kind, size, _, _) = tcfg.game_obj, GAMES[name]
    n = game.n_cells
    assert int(tree.n_children[0]) == n          # the root is fully tried
    empty = torch.zeros(n, dtype=torch.int8)
    term = filled_board(kind, size)
    assert not game.legal_mask(term).any()
    # lanes 0-1 at the fully tried root, 2-3 at terminal boards (on the
    # root's row and on the PAD row), 4 at node 5 with every cell legal:
    # a cell that none of its children took
    leaves = torch.tensor([0, 0, 0, tree.cap, 5], dtype=torch.int32)
    boards = torch.stack([empty, empty, term, term, empty])
    keys = rng.split(rng.key(3, "cpu"), 5)
    got = proposed(tree, leaves, boards, game, keys)
    np.testing.assert_array_equal(
        got.numpy(), jax_proposals(tree, leaves, boards, keys,
                                   jcfg.game_obj))
    assert got[:4].tolist() == [-1] * 4
    kids = tree.children[5, :int(tree.n_children[5])]
    assert 0 <= int(got[4]) and int(got[4]) not in tree.move[kids].tolist()
    # a forest: member 1's lanes all at a terminal board
    leaves, boards, keys = round_inputs(forest, member_boards, game, (E, 4), 4)
    boards[1] = term
    got = proposed(forest, leaves, boards, game, keys)
    assert got[1].tolist() == [-1] * 4
    np.testing.assert_array_equal(
        got.numpy(), jax_proposals(forest, leaves, boards, keys,
                                   jcfg.game_obj))


# ----------------------------------- the kernel's arithmetic, in numpy ----
def warp_argmax_mirror(values, take):
    """propose_move_kernel's steps 2-4 on one lane: thread t scans cells t,
    t + 32, ... in ascending order keeping a strictly greater value, the
    butterfly keeps "greater value, else lower cell"; -1 if no cell was
    taken (values of cells not taken are never looked at)."""
    n = values.size
    best = [(-1.0, 2**31 - 1)] * 32
    for t in range(32):
        for c in range(t, n, 32):
            if take[c] and values[c] > best[t][0]:
                best[t] = (float(values[c]), c)
    for off in (16, 8, 4, 2, 1):
        best = [max(best[t], best[t ^ off], key=lambda vc: (vc[0], -vc[1]))
                for t in range(32)]
    assert len(set(best)) == 1           # every thread holds the answer
    v, c = best[0]
    return c if v >= 0.0 else -1


@pytest.mark.parametrize("n", [1, 4, 25, 81, 121, 225, 625])
def test_warp_argmax_mirror_is_the_first_index_argmax(n):
    """On values with many ties (four levels), the kernel's reduction is
    torch.argmax of torch.where(take, v, -1) with its first-index rule."""
    r = np.random.default_rng(n)
    for _ in range(20):
        values = r.integers(0, 4, n).astype(np.float32) / 4
        take = r.random(n) < r.random()
        want = torch.argmax(torch.where(torch.from_numpy(take),
                                        torch.from_numpy(values), -1.0))
        expect = int(want) if take.any() else -1
        assert warp_argmax_mirror(values, take) == expect


def kernel_mirror(tree, leaves, legal, keys):
    """propose_move_kernel lane by lane: the tried bitmask from the leaf's
    first n_children slots (member-local ids, member l // (N / E)), a
    threefry draw for each untried legal cell only, the warp argmax."""
    t = {k: v.reshape(-1, *v.shape[tree.parent.dim():]).numpy()
         for k, v in (("children", tree.children),
                      ("n_children", tree.n_children), ("move", tree.move))}
    rows = tree.cap + 1
    members = tree.parent.shape[0] if tree.parent.dim() == 2 else 1
    lv = leaves.reshape(-1).numpy()
    lg = legal.reshape(len(lv), -1).numpy()
    kw = keys.reshape(-1, 2).numpy().astype(np.uint32)
    N, n = lg.shape
    out = np.empty(N, np.int32)
    for lane in range(N):
        base = lane // (N // members) * rows
        row = base + lv[lane]
        words = np.zeros((n + 31) // 32, np.uint32)
        for s in range(min(max(t["n_children"][row], 0),
                           t["children"].shape[1])):
            m = t["move"][base + t["children"][row, s]]
            if 0 <= m < n:
                words[m >> 5] |= np.uint32(1 << (m & 31))
        untried = np.array([not (words[c >> 5] >> np.uint32(c & 31)) & 1
                            for c in range(n)], bool)
        take = lg[lane] & untried
        values = np.full(n, np.nan, np.float32)    # never drawn: never read
        cells = np.flatnonzero(take)
        values[cells] = np_uniform((kw[lane, 0], kw[lane, 1]), cells)
        out[lane] = warp_argmax_mirror(values, take)
    return out.reshape(leaves.shape)


@pytest.mark.parametrize("name", ["hex7", "gomoku9"])
def test_kernel_mirror_matches_the_plain_version(name, grown):
    tree, forest, member_boards = grown[name]
    tcfg, _ = configs(name)
    game, W = tcfg.game_obj, tcfg.n_workers
    board = torch.zeros(game.n_cells, dtype=torch.int8)
    for t, b, lead in ((tree, board, (W,)), (forest, member_boards, (E, W))):
        leaves, boards, keys = round_inputs(t, b, game, lead, 5)
        legal = game.legal_mask(boards)
        got = tops.propose_move(t, leaves, legal, keys)
        np.testing.assert_array_equal(kernel_mirror(t, leaves, legal, keys),
                                      got.numpy())


# --------------------------------------------------------- the wrapper ----
def small_case():
    tree = tt.init_tree(64, 25, 1, device="cpu")
    leaves = torch.zeros(4, dtype=torch.int32)
    legal = torch.ones(4, 25, dtype=torch.bool)
    keys = rng.split(rng.split(rng.key(0, "cpu"), 4), 3)[:, 1]   # a view
    return tree, leaves, legal, keys


def test_lane_stride_reads_views_of_a_key_split():
    keys = rng.split(rng.split(rng.key(0, "cpu"), 12), 3).view(3, 4, 3, 2)
    assert tpm._lane_stride(keys[..., 1, :], (3, 4)) == 6
    assert tpm._lane_stride(keys[0, :, 1], (4,)) == 6
    assert tpm._lane_stride(keys[0, 0, 1], ()) == 2
    assert tpm._lane_stride(keys[:, :1, 1], (3, 1)) == 24
    flat = rng.split(rng.key(1, "cpu"), 12)
    assert tpm._lane_stride(flat, (12,)) == 2
    assert tpm._lane_stride(flat.view(4, 3, 2).transpose(0, 1), (3, 4)) is None


def test_propose_move_wrapper_refuses_what_the_kernel_does_not_take():
    tree, leaves, legal, keys = small_case()
    call = lambda t=tree, l=leaves, g=legal, k=keys: tpm.propose_move(
        t, l, g, k)
    with pytest.raises(ValueError, match="CUDA"):
        call()                                      # CPU tensors, a key view
    with pytest.raises(TypeError, match="legal is torch.int8"):
        call(g=legal.to(torch.int8))
    with pytest.raises(TypeError, match="leaf is torch.int64"):
        call(l=leaves.long())
    with pytest.raises(TypeError, match="key is torch.int32"):
        call(k=keys.int())
    with pytest.raises(TypeError, match="tree.move is torch.float32"):
        call(t=tree._replace(move=tree.move.float()))
    with pytest.raises(ValueError, match="legal has shape"):
        call(g=legal[:3])
    with pytest.raises(ValueError, match="key has shape"):
        call(k=torch.zeros(4, 3, dtype=torch.int64))   # the wrong width
    with pytest.raises(ValueError, match="key has shape"):
        call(k=keys[:2])
    with pytest.raises(ValueError, match="cells outside"):
        call(g=torch.ones(4, 626, dtype=torch.bool))
    with pytest.raises(ValueError, match="no lanes"):
        call(l=leaves[:0], g=legal[:0], k=keys[:0])
    with pytest.raises(ValueError, match="two words must be adjacent"):
        call(k=torch.zeros(2, 4, dtype=torch.int64).t())
    with pytest.raises(ValueError, match="tree.n_children has shape"):
        call(t=tree._replace(n_children=tree.n_children[:-1]))
    with pytest.raises(ValueError, match="tree.children must be contiguous"):
        call(t=tree._replace(children=tree.children.t().contiguous().t()))
    with pytest.raises(ValueError, match="legal must be contiguous"):
        call(g=torch.ones(25, 4, dtype=torch.bool).t())
    forest = tt.init_forest(E, 64, 25, 1, device="cpu")
    with pytest.raises(ValueError, match="member axis first"):
        call(t=forest)
    with pytest.raises(ValueError, match="CUDA"):
        call(t=forest, l=leaves[:3], g=legal[:3], k=keys[:3])
    assert _build._lib is None
    assert tpm.propose_move_plain is tref.propose_move


def test_every_path_proposes_through_the_dispatch_point(monkeypatch):
    """A batched sync iteration proposes once a selection round (one call
    for all lanes, and for all members of a forest); the scalar oracle once
    a lane; the sequential searcher once an iteration."""
    calls = []
    inner = tops.propose_move

    def counted(tree, leaf, legal, key):
        calls.append(tuple(leaf.shape))
        return inner(tree, leaf, legal, key)

    monkeypatch.setattr(tops, "propose_move", counted)
    board = torch.zeros(25, dtype=torch.int8)
    cfg = tg.GSCPMConfig(board_size=5, n_workers=8, n_tasks=8, n_playouts=32,
                         vl_rounds=2, tree_cap=256)
    tg.gscpm_search(board, 1, cfg, rng.key(1, "cpu"), device="cpu")
    assert calls == [(4,)] * 8                     # 4 iterations x 2 rounds
    calls.clear()
    trp.gscpm_search_batch(board, 1, cfg, rng.key(1, "cpu"), n_trees=E,
                           device="cpu")
    assert calls == [(E, 4)] * 8
    calls.clear()
    scalar = tg.GSCPMConfig(board_size=5, n_workers=4, n_tasks=4,
                            n_playouts=8, descent="scalar", tree_cap=256)
    tg.gscpm_search(board, 1, scalar, rng.key(1, "cpu"), device="cpu")
    assert calls == [()] * 8
    calls.clear()
    from repro_torch.core.mcts import uct_search
    uct_search(board, 1, 6, rng.key(1, "cpu"), board_size=5, tree_cap=64,
               device="cpu")
    assert calls == [()] * 6
