"""Tools for holding two runs of the search against each other.

Everything on the search's path is integer- or bool-valued except the UCT
scores, whose ``log``/``sqrt``/divide may round differently between two
implementations (the JAX package on XLA:CPU, the port's plain version, the
CUDA kernel). Two runs are therefore either identical field by field, or
they part at one child pick whose two best scores were closer than float
rounding can resolve. These helpers find that pick, so a comparison never
has to be loosened: ``chip_smoke.py`` uses them for kernel vs plain on the
card, the tests for the port vs the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.core import gscpm, scheduler as sched
from repro_torch.core import uct as uct_mod
from repro_torch.core.game import EMPTY
from repro_torch.core.tree import Tree, child_stat_tile
from repro_torch.kernels import ops

TIE_GAP = 1e-6  # a pick whose top-two score gap is below this may go either way


def differing_fields(a: Tree, b: Tree) -> list[str]:
    """Names of the ``Tree`` fields in which ``a`` and ``b`` differ."""
    return [name for name, x, y in zip(Tree._fields, a, b)
            if not torch.equal(x.cpu(), y.cpu())]


def clone_tree(tree: Tree) -> Tree:
    return Tree(*(t.clone() for t in tree))


def top_two_gap(wins, visits, vloss, parent_total, valid, cp, noise=None,
                lane_mask=None) -> torch.Tensor:
    """(W,) gap between the best and second-best final score of each row, by
    the plain version's arithmetic (inf for a one-slot row, 0 for a tie)."""
    if lane_mask is not None:
        valid = valid & lane_mask[..., None]
    scores = uct_mod.noisy_scores(
        uct_mod.uct_scores(wins, visits, vloss, parent_total, cp, valid),
        noise)
    # +-inf only arise without noise; bring them to the kernel's +-1e30 so
    # that a tie among unvisited slots reads as gap 0, not nan
    scores = torch.clamp(scores, min=-1e30, max=1e30)
    if scores.shape[-1] < 2:
        return torch.full(scores.shape[:-1], torch.inf, device=scores.device)
    top = scores.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def iteration_plan(cfg: gscpm.GSCPMConfig, key: torch.Tensor):
    """Yield ``(iter_keys, active)`` for every sync iteration of the search
    ``gscpm_search(cfg, key)`` runs, in order — the search's whole RNG
    schedule, so that two implementations can be stepped side by side."""
    schedule = sched.make_schedule(
        cfg.n_playouts, cfg.n_tasks, cfg.n_workers, cfg.scheduler)
    for rnd in schedule:
        task_ids = torch.as_tensor(rnd.task_ids, dtype=torch.int32,
                                   device=key.device)
        task_keys = gscpm.fold_task_keys(key, task_ids)
        active = torch.as_tensor(rnd.active, device=key.device)
        for i in range(int(rnd.m)):
            yield rng.fold_in(task_keys, i), active


def first_divergent_pick(tree: Tree, root_board: torch.Tensor,
                         cfg: gscpm.GSCPMConfig, cp,
                         iter_keys: torch.Tensor, other_select):
    """Replay one sync iteration's lockstep descent on ``tree`` (which is
    not modified) and hold every level's picks against ``other_select``.

    The descent is driven by ``kernels.ops.uct_select`` exactly as
    ``select_batch`` drives it; at each level ``other_select(wins, visits,
    vloss, parent_total, valid, cp, noise=, lane_mask=)`` is called on the
    same tile. Returns None if all live picks agree, else a dict with the
    first disagreement: ``level``, ``lane``, ``pick``, ``other_pick`` and
    the row's top-two score ``gap``. Single virtual-loss round only.
    """
    if cfg.vl_rounds != 1:
        raise ValueError("first_divergent_pick handles vl_rounds == 1 only")
    game = cfg.game_obj
    max_depth = game.max_moves + 1
    C = tree.max_children
    W = iter_keys.shape[0]
    dev = root_board.device
    noise_keys = rng.split(iter_keys, 3)[:, 0]

    nodes = torch.zeros((W,), dtype=torch.int32, device=dev)
    boards = root_board[None, :].repeat(W, 1)
    depths = torch.zeros((W,), dtype=torch.int32, device=dev)
    n_empty = (root_board == EMPTY).sum().to(torch.int32).expand(W)
    done = torch.zeros((W,), dtype=torch.bool, device=dev)
    lanes = torch.arange(W, device=dev)
    level = 0
    while not bool(done.all()):
        fully = (tree.n_children[nodes] == n_empty) & (n_empty != 0)
        safe, valid, wins, visits, vloss, ptot = child_stat_tile(tree, nodes)
        noise = (gscpm.level_noise(noise_keys, depths, C, cfg.select_noise)
                 if cfg.select_noise > 0.0 else None)
        args = (wins, visits, vloss, ptot, valid, cp)
        picks = ops.uct_select(*args, noise=noise, lane_mask=~done)
        other = other_select(*args, noise=noise, lane_mask=~done)
        step = fully & (depths < max_depth - 2) & ~done
        differ = (picks != other.to(picks.device)) & step
        if bool(differ.any()):
            lane = int(torch.nonzero(differ)[0, 0])
            gap = top_two_gap(*args, noise=noise, lane_mask=~done)
            return {"level": level, "lane": lane, "pick": int(picks[lane]),
                    "other_pick": int(other[lane]), "gap": float(gap[lane])}
        child = safe[lanes, picks]
        mv = torch.clamp(tree.move[child], min=0)
        new_boards = game.place(boards, mv, tree.to_move[nodes])
        nodes = torch.where(step, child, nodes)
        boards = torch.where(step[:, None], new_boards, boards)
        depths = torch.where(step, depths + 1, depths)
        n_empty = torch.where(step, n_empty - 1, n_empty)
        done = done | ~step
        level += 1
    return None
