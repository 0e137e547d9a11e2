"""Closed loop of batched cold move requests: one call searches ``members``
independent positions at once, and the next call is sent when it returns.

The positions are random openings: ``k`` plies on distinct cells chosen
uniformly, player 1 first, players alternating; the player to move is the
one whose turn follows. A position where a player has already won (in Gomoku
a five) is drawn again. Set-up makes ``BLOCKS`` blocks of ``members``
positions from the seed; call ``i`` takes block ``i % BLOCKS``. Every block
holds the same multiset of opening lengths (``members`` lengths counted out
evenly over ``opening_plies``, in an order drawn from the seed), so every
call and every seed asks for the same amount of work, on other positions.

Call ``i``'s key is ``fold_in(key_from_seed(seed), i)``; the warm-up (index
-1) folds in 2**32 - 1, which no timed call reaches. Member ``e`` of a call
searches with ``fold_in(call key, e)``, as the program is specified to, so
the reference (``reference.search``) checks any member on its own.

Parameters (``workloads/<cell>.json``): ``members``, ``opening_plies``
([lo, hi]), and the search's budget under ``search`` (``n_playouts``,
``n_tasks``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mctsbench import work
from mctsbench.reference import games, search, threefry

BLOCKS = 4


@dataclasses.dataclass
class Step:
    playouts: int       # playouts the call completed
    iterations: int     # sync iterations it ran
    kept: dict          # the kept members' answers (``Program.stash``)
    stats: dict         # the program's own report of the call


class Traffic:
    def __init__(self, params: dict, config: dict, seed: int):
        self.config = config
        self.game = games.make(config["game"], int(config["board_size"]))
        self.members = int(params["members"])
        self.n_playouts = int(params["search"]["n_playouts"])
        self.n_tasks = int(params["search"]["n_tasks"])
        self.iterations = sum(m for m, _, _ in search.schedule(
            self.n_playouts, self.n_tasks, int(config["n_workers"]),
            config["scheduler"]))
        lo, hi = (int(x) for x in params["opening_plies"])
        n = self.game.n_cells
        if not 0 <= lo <= hi < n:
            raise ValueError(f"opening_plies {lo}..{hi} on {n} cells")
        self.key = threefry.key_from_seed(seed)
        rng = np.random.default_rng([seed, 0])
        spread = lo + np.arange(self.members) % (hi - lo + 1)
        plies = np.stack([rng.permutation(spread) for _ in range(BLOCKS)])
        boards, to_move = openings(self.game, plies.reshape(-1), rng)
        self.boards = boards.reshape(BLOCKS, self.members, n)
        self.to_move = to_move.reshape(BLOCKS, self.members)

    # ------------------------------------------------ the program's side ----
    def setup(self, program) -> None:
        """The position pool on the device."""
        self._boards, self._to_move = program.upload(self.boards,
                                                     self.to_move)

    def warm_up(self, program) -> None:
        """One sync iteration of every lane at the cell's own size: every
        kernel launched and every buffer of a call allocated."""
        W = program.cfg.n_workers
        self._call(program, -1, n_playouts=W, n_tasks=W)

    def step(self, program, i: int, keep: list[int],
             metrics: bool = False) -> Step:
        """Call ``i``; the answers of members ``keep`` are kept."""
        forest, stats = self._call(program, i, metrics=metrics)
        return Step(int(stats["playouts"]), self.iterations,
                    program.stash(forest, stats, keep), stats)

    def _call(self, program, i: int, **settings):
        b = block(i)
        return program.search(self._boards[b], self._to_move[b],
                              self.call_key(i), **settings)

    def counts(self, step: Step, i: int) -> dict:
        """The cost stages' inputs from call ``i``'s counters."""
        return work.search_counts(step.stats["metrics"], self.boards[block(i)],
                                  self.config["game"], self.members,
                                  int(self.config["n_workers"]))

    # ---------------------------------------------- the reference's side ----
    def call_key(self, i: int) -> np.ndarray:
        """(2,) uint32: call ``i``'s key."""
        return threefry.fold_in(self.key, i & threefry.MASK)

    def call(self, i: int):
        """(boards (members, n) int8, to_move (members,) int32, key (2,)
        uint32) of call ``i``."""
        b = block(i)
        return self.boards[b], self.to_move[b], self.call_key(i)

    def reference(self, picks, precision: str = "float32", log=None,
                  workers: int = 1) -> list[dict]:
        """The reference's answers for ``picks``, [(call, members)], in
        order."""
        boards, to_move, keys = [], [], []
        for i, members in picks:
            b, tm, key = self.call(i)
            boards.append(b[members])
            to_move.append(tm[members])
            keys.append(threefry.fold_in(key, np.asarray(members)))
        return search.search_members(
            self.game, self.config, self.n_playouts, self.n_tasks,
            np.concatenate(boards), np.concatenate(to_move),
            np.concatenate(keys), precision=precision, log=log,
            workers=workers)


def block(i: int) -> int:
    return max(i, 0) % BLOCKS


def openings(game, plies: np.ndarray, rng):
    """Random openings of ``plies[j]`` plies: (P, n) int8 boards and (P,)
    int32 sides to move; positions with a winner are drawn again."""
    P, n = len(plies), game.n_cells
    boards = np.zeros((P, n), dtype=np.int8)
    todo = np.arange(P)
    while len(todo):
        order = np.argsort(rng.random((len(todo), n)), axis=1)
        k = plies[todo][:, None]
        turn = np.arange(n)[None, :]
        stones = np.where(turn < k, np.where(turn % 2 == 0, 1, 2), 0)
        drawn = np.zeros((len(todo), n), dtype=np.int8)
        np.put_along_axis(drawn, order, stones.astype(np.int8), axis=1)
        boards[todo] = drawn
        todo = todo[game.has_winner(drawn)]
    return boards, (1 + plies % 2).astype(np.int32)
