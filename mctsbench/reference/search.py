"""Grain-size controlled parallel MCTS (GSCPM) in plain NumPy: the yardstick
that decides whether the searched program answered a move request right.

One call searches ``M`` independent root positions (members), each with
``W`` lanes on its own tree, exactly as the batched program is specified to
(member ``e`` of a batched call with key ``K`` searches with the member key
``fold_in(K, e)``; members share nothing). What a member does, in order:

- **Schedule** (FIFO work-sharing): ``n_tasks`` tasks of ``m = n_playouts //
  n_tasks`` iterations; round ``r`` gives lane ``w`` task ``r * W + w``
  (idle past ``n_tasks``) and the lane's key ``fold_in(member_key, task)``.
- **Sync iteration** ``i`` of a round: the lane's key ``fold_in(task_key,
  i)`` splits into three (``split(., 3)``): the descent's, the proposal's
  and the playout's.
- **Descent**: from the root, a lane steps to a child while its node's
  children cover every empty cell of its board (and the board is not full,
  and the depth is below the number of cells less one). The child is the
  first slot of greatest score ``(w/d + cp * sqrt(log(N) / d)) + noise``,
  with ``d = max(n, 1)`` the child's visits, ``N = max(parent visits, 1)``,
  and ``noise = select_noise * uniform(fold_in(key, depth), C)[slot]``; an
  unvisited child scores ``1e30 + noise``. All in float32. The logarithm is
  the platform's float32 one (``log``): correctly rounded by default, and on
  a CUDA card the card's ``logf``, which is not (``card_log``). Slots are in
  the order the children were made.
- **Proposal**: among the legal moves of the lane's leaf board that have no
  child yet, the first greatest of ``uniform(move key, n_cells)``; none if
  there is no such move.
- **Expansion**: the lanes' (leaf, move) proposals in (leaf, move, lane)
  order; the first of each distinct pair gets the next node id (and the
  next child slot of its leaf), the others share its node.
- **Playout**: from the leaf board with the proposed move made (by the
  player to move at the leaf), a random fill (``games``) under the playout
  key.
- **Backup**: every node on the lane's path, and the new node, gets one
  visit and, as its win, 1 when the player who moved into it won the
  playout, 0.5 on a draw, 0 otherwise.

The answer to a request is the member's tree (node ids, parents, moves,
visits, wins) and its best move, the root child of most visits (the first
slot on equal visits).

``precision="bfloat16"`` rounds every operation of the score to bfloat16:
the benchmark's control, the lower-precision search that its comparison has
to tell apart from a right answer.
"""

from __future__ import annotations

import math

import numpy as np

from mctsbench.reference import threefry

F32 = np.float32
NO_NODE = -1


def schedule(n_playouts: int, n_tasks: int, n_workers: int, policy: str):
    """[(m, task ids (W,), active (W,))] per round of the FIFO schedule."""
    if policy != "fifo":
        raise ValueError(f"the reference schedules 'fifo', not {policy!r}")
    n_tasks = max(1, min(n_tasks, n_playouts))
    m = max(1, n_playouts // n_tasks)
    rounds = []
    for r in range(math.ceil(n_tasks / n_workers)):
        ids = r * n_workers + np.arange(n_workers, dtype=np.int64)
        rounds.append((m, ids, ids < n_tasks))
    return rounds


def _identity(x):
    return x


def correct_log(x: np.ndarray) -> np.ndarray:
    """The float32 natural logarithm rounded correctly, through float64."""
    return np.log(x.astype(np.float64)).astype(F32)


class LogTable:
    """A float32 natural logarithm read from a table of its values at the
    integers 1..len(table): the score takes the log of a visit count only
    (in the control, of one rounded to bfloat16: still an integer). A
    table is plain data, so worker processes take it as it is."""

    def __init__(self, table: np.ndarray):
        self.table = np.asarray(table, dtype=F32)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        i = np.asarray(x).astype(np.int64)
        if not (np.array_equal(i, x) and (i >= 1).all()
                and (i <= len(self.table)).all()):
            raise ValueError("the log table covers the integers 1.."
                             f"{len(self.table)} only")
        return self.table[i - 1]


def card_log(device, upto: int = 1 << 20) -> LogTable:
    """The float32 natural logarithm as a CUDA card computes it (``logf``,
    through PyTorch's ``torch.log``) at the integers 1..``upto``: within an
    ulp of the correctly rounded one, and not always equal to it."""
    import torch

    x = torch.arange(1, upto + 1, dtype=torch.float32, device=device)
    return LogTable(torch.log(x).cpu().numpy())


def to_bfloat16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    as float32."""
    b = np.asarray(x, dtype=F32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
         ) & np.uint32(0xFFFF0000)
    return b.view(F32)


class Search:
    """The search state of ``M`` members: trees as (M, cap + 1[, C]) arrays
    with a PAD row at ``cap``."""

    def __init__(self, game, cfg: dict, n_playouts: int, n_tasks: int,
                 precision: str = "float32", log=None):
        if int(cfg.get("vl_rounds", 1)) != 1:
            raise ValueError("the reference runs one selection round a sync "
                             "iteration (vl_rounds 1)")
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision {precision!r}")
        self.game = game
        self.W = int(cfg["n_workers"])
        self.cap = int(cfg["tree_cap"])
        self.cp = F32(cfg["cp"])
        self.noise_scale = F32(cfg["select_noise"])
        self.n_playouts, self.n_tasks = int(n_playouts), int(n_tasks)
        self.policy = cfg.get("scheduler", "fifo")
        self.r = to_bfloat16 if precision == "bfloat16" else _identity
        self.log = correct_log if log is None else log

    # ---------------------------------------------------------- helpers ----
    def _log(self, x):
        return self.r(self.log(self.r(x)))

    def _scores(self, wins, visits, log_np, valid, noise):
        r = self.r
        n_j = r(visits)
        d = r(np.maximum(n_j, F32(1.0)))
        x = r(r(wins) / d)
        explore = r(self.cp * r(np.sqrt(r(log_np[:, None] / d))))
        s = r(r(x + explore) + noise)
        s = np.where(n_j <= 0, r(F32(1e30) + noise), s)
        return np.where(valid, s, F32(-np.inf))

    # ----------------------------------------------------------- search ----
    def run(self, boards: np.ndarray, to_move: np.ndarray,
            member_keys: np.ndarray) -> list[dict]:
        """Search every member from its (n,) board, its side to move and its
        (2,) key; the answers, one dict a member."""
        boards = np.asarray(boards, dtype=np.int8)
        M, n = boards.shape
        C, cap = self.game.n_cells, self.cap
        self.parent = np.full((M, cap + 1), NO_NODE, dtype=np.int32)
        self.move = np.full((M, cap + 1), NO_NODE, dtype=np.int32)
        self.to_move = np.zeros((M, cap + 1), dtype=np.int32)
        self.to_move[:, 0] = np.asarray(to_move, dtype=np.int32)
        self.children = np.full((M, cap + 1, C), NO_NODE, dtype=np.int32)
        self.n_children = np.zeros((M, cap + 1), dtype=np.int32)
        self.visits = np.zeros((M, cap + 1), dtype=F32)
        self.wins = np.zeros((M, cap + 1), dtype=F32)
        self.n_nodes = np.ones(M, dtype=np.int64)
        member_keys = np.asarray(member_keys, dtype=np.uint32)
        for m, task_ids, active in schedule(self.n_playouts, self.n_tasks,
                                            self.W, self.policy):
            task_keys = threefry.fold_in(member_keys[:, None, :],
                                         task_ids[None, :])
            for i in range(m):
                self._iteration(boards, threefry.fold_in(task_keys, i),
                                active)
        return [self._answer(e) for e in range(M)]

    def _iteration(self, roots, keys, active):
        ks = threefry.split(keys, 3)
        leaves, boards, depths, paths = self._descend(roots, ks[..., 0, :])
        moves = self._propose(leaves, boards, ks[..., 1, :])
        new_ids = self._expand(leaves, moves, active)
        M, W = leaves.shape
        mi = np.arange(M)[:, None]
        wi = np.arange(W)[None, :]
        paths[mi, wi, depths + 1] = new_ids
        movers = self.to_move[mi, leaves]
        made = moves >= 0
        after = boards.copy()
        mm, mw = np.nonzero(made)
        after[mm, mw, moves[mm, mw]] = movers[mm, mw]
        nxt = np.where(made, 3 - movers, movers)
        n = roots.shape[1]
        values = self.game.playout(after.reshape(-1, n), nxt.reshape(-1),
                                   ks[..., 2, :].reshape(-1, 2)).reshape(M, W)
        self._backup(paths, values, active)

    def _descend(self, roots, keys):
        M, n = roots.shape
        W, C, cap = self.W, self.game.n_cells, self.cap
        max_depth = n + 1
        node = np.zeros((M, W), dtype=np.int64)
        depth = np.zeros((M, W), dtype=np.int64)
        empties = np.repeat((roots == 0).sum(axis=1)[:, None], W, axis=1)
        boards = np.repeat(roots[:, None, :], W, axis=1)
        paths = np.full((M, W, max_depth), cap, dtype=np.int64)
        paths[..., 0] = 0
        done = np.zeros((M, W), dtype=bool)
        slots = np.arange(C)
        while True:
            n_kids = self.n_children[np.arange(M)[:, None], node]
            go = (~done & (n_kids == empties) & (empties != 0)
                  & (depth < max_depth - 2))
            done |= ~go
            if not go.any():
                return node, boards, depth, paths
            gm, gw = np.nonzero(go)
            nd = node[gm, gw]
            valid = slots[None, :] < n_kids[gm, gw][:, None]
            safe = np.where(valid, self.children[gm, nd], cap)
            log_np = self._log(np.maximum(self.visits[gm, nd], F32(1.0)))
            noise = F32(0.0)
            if self.noise_scale > 0:
                level_keys = threefry.fold_in(keys[gm, gw], depth[gm, gw])
                noise = self.r(self.noise_scale
                               * threefry.uniform(level_keys, C))
            s = self._scores(self.wins[gm[:, None], safe],
                             self.visits[gm[:, None], safe], log_np, valid,
                             noise)
            child = safe[np.arange(len(gm)), np.argmax(s, axis=1)]
            boards[gm, gw, self.move[gm, child]] = self.to_move[gm, nd]
            paths[gm, gw, depth[gm, gw] + 1] = child
            node[gm, gw] = child
            depth[gm, gw] += 1
            empties[gm, gw] -= 1

    def _propose(self, leaves, boards, keys):
        M, W, n = boards.shape
        C, cap = self.game.n_cells, self.cap
        mi = np.arange(M)[:, None]
        kids = self.children[mi, leaves]                         # (M, W, C)
        valid = np.arange(C) < self.n_children[mi, leaves][..., None]
        tried_moves = np.where(
            valid, self.move[mi[..., None], np.where(valid, kids, cap)], n)
        tried = np.zeros((M, W, n + 1), dtype=bool)
        np.put_along_axis(tried, tried_moves.astype(np.int64), True, axis=-1)
        untried = self.game.legal(boards) & ~tried[..., :n]
        u = threefry.uniform(keys, n)
        mv = np.argmax(np.where(untried, u, F32(-1.0)), axis=-1)
        return np.where(untried.any(axis=-1), mv, NO_NODE)

    def _expand(self, leaves, moves, active):
        """Allocate the distinct proposals of each member; the (M, W) node
        each lane's proposal got (``cap`` for none)."""
        M, W = leaves.shape
        cap, C = self.cap, self.game.n_cells
        new_ids = np.full((M, W), cap, dtype=np.int64)
        big = np.int64(1) << 40
        for m in range(M):
            valid = (moves[m] >= 0) & active
            leaf_k = np.where(valid, leaves[m], big)
            move_k = np.where(valid, moves[m], big)
            order = np.lexsort((move_k, leaf_k))
            ls, ms, vs = leaf_k[order], move_k[order], valid[order]
            first = np.ones(W, dtype=bool)
            first[1:] = (ls[1:] != ls[:-1]) | (ms[1:] != ms[:-1])
            first &= vs
            g = np.cumsum(first) - 1
            nn = self.n_nodes[m]
            can = (nn + g < cap) & vs
            alloc = first & can
            new_s = np.where(can, nn + g, cap)
            prev = np.concatenate([[-1], ls[:-1]])
            start = np.maximum.accumulate(np.where(ls != prev, g, -1))
            a_leaf, a_move, a_id = ls[alloc], ms[alloc], new_s[alloc]
            slot = np.minimum(self.n_children[m, a_leaf] + (g - start)[alloc],
                              C - 1)
            self.parent[m, a_id] = a_leaf
            self.move[m, a_id] = a_move
            self.to_move[m, a_id] = 3 - self.to_move[m, a_leaf]
            self.children[m, a_leaf, slot] = a_id
            np.add.at(self.n_children[m], a_leaf, 1)
            self.n_nodes[m] += int(alloc.sum())
            new_ids[m, order] = np.where(vs & can, new_s, cap)
        return new_ids

    def _backup(self, paths, values, active):
        M, W, D = paths.shape
        for m in range(M):
            on = (paths[m] != self.cap) & active[:, None]
            rows = paths[m][on]
            v = np.repeat(values[m][:, None], D, axis=1)[on]
            mover = 3 - self.to_move[m, rows]
            credit = np.where(v == 0, F32(0.5), (mover == v).astype(F32))
            np.add.at(self.visits[m], rows, F32(1.0))
            np.add.at(self.wins[m], rows, credit.astype(F32))

    def _answer(self, m: int) -> dict:
        nn = int(self.n_nodes[m])
        k = int(self.n_children[m, 0])
        best = NO_NODE
        if k:
            kids = self.children[m, 0, :k]
            best = int(self.move[m, kids[np.argmax(self.visits[m, kids])]])
        return {"n_nodes": nn, "best_move": best,
                "parent": self.parent[m, :nn].copy(),
                "move": self.move[m, :nn].copy(),
                "visits": self.visits[m, :nn].copy(),
                "wins": self.wins[m, :nn].copy()}


def search_members(game, cfg: dict, n_playouts: int, n_tasks: int,
                   boards, to_move, member_keys, precision: str = "float32",
                   log=None, workers: int = 1) -> list[dict]:
    """The reference's answers for ``M`` members (see the module's text),
    searched in ``workers`` processes of their own when more than one:
    members share nothing, so each process takes a block of them."""
    args = (game, cfg, n_playouts, n_tasks)
    blocks = np.array_split(np.arange(len(boards)), max(1, min(
        workers, len(boards))))
    if len(blocks) == 1:
        return _search_block(args, precision, log, boards, to_move,
                             member_keys)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(len(blocks), mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        done = [pool.submit(_search_block, args, precision, log,
                            np.asarray(boards)[b], np.asarray(to_move)[b],
                            np.asarray(member_keys)[b]) for b in blocks]
        return [a for f in done for a in f.result()]


def _search_block(args, precision, log, boards, to_move, member_keys):
    return Search(*args, precision, log).run(boards, to_move, member_keys)


def reference_workers() -> int:
    """Processes for the reference: the cores this process may use, at most
    eight."""
    import os

    return max(1, min(8, len(os.sched_getaffinity(0))))
