"""Tools for holding two runs of the search against each other.

Everything on the search's path is integer- or bool-valued except the UCT
scores, whose ``log``/``sqrt``/divide may round differently between two
implementations (the JAX package on XLA:CPU, the port's plain version, the
CUDA kernel). Two runs are therefore either identical field by field, or
they part at one child pick whose two best scores were closer than float
rounding can resolve. These helpers find that pick, so a comparison never
has to be loosened: ``chip_smoke.py`` uses them for kernel vs plain on the
card, the tests for the port vs the JAX package.

The LM search is float-valued throughout (logits, values, wins), so two
runs of it in bfloat16 part by more than rounding: ``step_decode_search``
measures by how much, and holds every decision on which they part to the
error measured in the numbers that decision was taken on.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch import rng
from repro_torch.core import gscpm, scheduler as sched
from repro_torch.core import uct as uct_mod
from repro_torch.core.game import EMPTY
from repro_torch.core.tree import Tree, child_stat_tile, init_tree
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


# ------------------------------------------------------------ LM decoding ----
def _uct_row(tree: Tree, node: int, lane: int, level: int,
             noise_keys: torch.Tensor, cfg):
    """The final scores (C,) that lane ``lane``'s pick among ``node``'s
    children at descent level ``level`` is the argmax of, by the plain
    arithmetic, as ``select_token_batch`` forms them."""
    dev = noise_keys.device
    _, valid, wins, visits, vloss, ptot = child_stat_tile(
        tree, torch.tensor([node], dtype=torch.int32, device=dev))
    noise = gscpm.level_noise(
        noise_keys[lane:lane + 1],
        torch.tensor([level], dtype=torch.int32, device=dev),
        tree.max_children, cfg.select_noise)
    scores = uct_mod.noisy_scores(
        uct_mod.uct_scores(wins, visits, vloss, ptot, cfg.cp, valid), noise)
    return torch.clamp(scores, min=-1e30, max=1e30)[0]


def _parting(kind: str, lane: int, values_a: torch.Tensor,
             values_b: torch.Tensor, pick_a: int, pick_b: int,
             slack: float = 0.0, **where) -> dict:
    """One decision on which run a picked ``pick_a`` by its numbers
    ``values_a`` and run b ``pick_b`` by ``values_b``. ``err`` is the largest
    difference between the two runs' numbers, ``gaps`` each run's margin for
    its own pick over the other's. Both picks are right, and the flip is
    ``excused``, only if both margins lie in [0, 2 err]: a negative margin
    is a run that did not pick its own best, a wider one cannot come from
    the numbers' error. ``slack`` allows for rounding in forming the
    numbers; an exact tie on equal numbers is the tie rule's to decide, and
    is never excused."""
    err = float((values_a - values_b).abs().max())
    gaps = [float(values_a[pick_a] - values_a[pick_b]),
            float(values_b[pick_b] - values_b[pick_a])]
    excused = (all(-slack <= g <= 2 * err + slack for g in gaps)
               and (err > 0 or any(g != 0 for g in gaps)))
    return {"decision": kind, "lane": lane, **where, "picks": [pick_a, pick_b],
            "gaps": gaps, "err": err, "excused": excused}


def _decode_partings(before: tuple[Tree, Tree], cfg, a: dict, b: dict,
                     noise_keys: torch.Tensor) -> tuple[list[dict], float,
                                                        float]:
    """Every lane's first decision of one iteration on which the recorded
    runs ``a`` and ``b`` (``_iteration``'s ``record``) part, in the order
    the iteration takes them: the descent's UCT picks, the proposal's
    top-k, the proposal itself, and — when every lane proposed the same —
    the rollout's first token and its samples. Also the largest leaf-logit
    and rollout-logit differences, each over the lanes (and rollout steps)
    whose tokens so far agree, the only ones whose logits are comparable."""
    out = []
    W = a["paths"].shape[0]
    same_path = (a["paths"] == b["paths"]).all(dim=1)
    for lane in torch.nonzero(~same_path).flatten().tolist():
        col = int(torch.nonzero(a["paths"][lane] != b["paths"][lane])[0, 0])
        node = int(a["paths"][lane, col - 1])
        kids = before[0].children[node]
        pa, pb = (torch.nonzero(kids == r["paths"][lane, col]) for r in (a, b))
        if pa.numel() == 0 or pb.numel() == 0:
            out.append({"decision": "uct_pick", "lane": lane, "level": col - 1,
                        "excused": False, "note": "a pick off the children"})
            continue
        sa, sb = (_uct_row(t, node, lane, col - 1, noise_keys, cfg)
                  for t in before)
        out.append(_parting("uct_pick", lane, sa, sb, int(pa[0, 0]),
                            int(pb[0, 0]), slack=TIE_GAP, level=col - 1))
    leaf_diff = (a["leaf_logits"] - b["leaf_logits"]).abs().amax(dim=-1)
    leaf_err = float(leaf_diff[same_path].max()) if same_path.any() else 0.0
    for lane in torch.nonzero(same_path).flatten().tolist():
        diff = torch.nonzero(a["top"][lane] != b["top"][lane])
        if diff.numel():
            i = int(diff[0, 0])
            out.append(_parting("top_k", lane, a["leaf_logits"][lane],
                                b["leaf_logits"][lane], int(a["top"][lane, i]),
                                int(b["top"][lane, i]), rank=i))
        elif a["moves"][lane] != b["moves"][lane]:
            # same tree, same top-k, same gumbel: nothing may part here
            out.append({"decision": "proposal", "lane": lane,
                        "excused": False, "note": "same inputs, other pick"})
    if not torch.equal(a["moves"], b["moves"]):
        # the batch's expansions differ: no lane's rollout is comparable
        return out, leaf_err, 0.0
    samples_a, samples_b = (torch.stack(r["samples"]) for r in (a, b))
    parts = samples_a != samples_b                                  # (T, W)
    # a rollout step is comparable while every token fed so far agrees:
    # the first one, and the samples of the steps before it
    fed_same = ((a["rollout_first"] == b["rollout_first"])[None, :]
                & (torch.cumsum(parts.int(), 0) - parts.int() == 0))
    errs = (torch.stack(a["rollout_logits"])
            - torch.stack(b["rollout_logits"])).abs().amax(dim=-1)  # (T, W)
    rollout_err = float(errs[fed_same].max()) if fed_same.any() else 0.0
    for lane in range(W):
        fa, fb = int(a["rollout_first"][lane]), int(b["rollout_first"][lane])
        if fa != fb:
            # an unexpanded lane rolls out from its leaf's argmax
            out.append(_parting("rollout_first", lane, a["leaf_logits"][lane],
                                b["leaf_logits"][lane], fa, fb))
        elif parts[:, lane].any():
            t = int(torch.nonzero(parts[:, lane])[0, 0])
            out.append(_parting("rollout_sample", lane, a["scores"][t][lane],
                                b["scores"][t][lane], int(samples_a[t, lane]),
                                int(samples_b[t, lane]), step=t))
    return out, leaf_err, rollout_err


def step_decode_search(params, mcfg, cfg, prompt: torch.Tensor,
                       key: torch.Tensor, other) -> dict:
    """Run ``mcts_decode_search(params, mcfg, prompt, cfg, key)`` twice side
    by side, one sync iteration at a time from the same keys: run a as
    called, run b inside the context ``other()`` (``ops.plain_versions`` to
    hold the kernels against their plain versions).

    Measured in every iteration: the largest difference between the two
    runs' root logits (prefill), leaf logits (replay decode) and rollout
    logits (rollout decode) wherever the two were fed the same tokens,
    beside the largest logit of run b. Every decision on which the runs part
    is held to the difference of the numbers it was taken on
    (``_parting``). Decisions are compared while the two trees keep the
    same shape and visits (wins may differ by the values' error); after the
    iteration in which they part, both searches run on to their end
    uncompared.

    Returns a dict: ``iterations`` compared of ``of``; ``root_err``,
    ``leaf_err``, ``rollout_err`` and ``max_abs_logit``; ``partings`` (how
    many decisions parted), ``first`` and ``unexcused`` (those decisions);
    ``parted_at`` (the iteration after which the trees differ in shape or
    visits, else None); ``best_tokens`` of the two runs' final trees.
    """
    from repro_torch.core.tree import best_child
    from repro_torch.models import api
    from repro_torch.serve import mcts_decode as md
    contexts = (contextlib.nullcontext, other)
    prompt = prompt.to(device=key.device, dtype=torch.int32).reshape(-1)
    P, W = int(prompt.shape[0]), cfg.n_workers
    max_len = P + cfg.max_depth + cfg.rollout_len + 1
    runs = []
    for ctx in contexts:
        with ctx():
            logits, cache = api.prefill(
                params, mcfg, {"tokens": prompt[None, :].repeat(W, 1)},
                max_len)
        runs.append([init_tree(cfg.tree_cap, cfg.branch, 1, device=key.device),
                     cache, logits[0, 0].to(torch.float32)])
    report = {"iterations": 0, "of": 0,
              "root_err": float((runs[0][2] - runs[1][2]).abs().max()),
              "leaf_err": 0.0, "rollout_err": 0.0,
              "max_abs_logit": float(runs[1][2].abs().max()),
              "partings": 0, "first": None, "unexcused": [],
              "parted_at": None}
    shape = [f for f in Tree._fields if f != "wins"]
    for it, (keys, active) in enumerate(iteration_plan(cfg, key)):
        report["of"] = it + 1
        parted = report["parted_at"] is not None
        before, recs = [], []
        for run, ctx in zip(runs, contexts):
            before.append(None if parted else clone_tree(run[0]))
            rec: dict | None = None if parted else {}
            with ctx():
                run[0], run[1] = md._iteration(
                    run[0], params, mcfg, cfg, run[1], run[2], P, cfg.cp,
                    keys, active, record=rec)
            recs.append(rec)
        if parted:
            continue   # two different searches now: run them to their end
        a, b = recs
        report["iterations"] = it + 1
        found, leaf_err, rollout_err = _decode_partings(
            tuple(before), cfg, a, b, rng.fold_in(keys, 0))
        report["leaf_err"] = max(report["leaf_err"], leaf_err)
        report["rollout_err"] = max(report["rollout_err"], rollout_err)
        report["max_abs_logit"] = max(
            [report["max_abs_logit"], float(b["leaf_logits"].abs().max())]
            + [float(x.abs().max()) for x in b["rollout_logits"]])
        for d in found:
            d["iteration"] = it
        report["partings"] += len(found)
        report["first"] = report["first"] or (found[0] if found else None)
        report["unexcused"] += [d for d in found if not d["excused"]]
        ta, tb = (dict(zip(Tree._fields, r[0])) for r in runs)
        if any(not torch.equal(ta[f], tb[f]) for f in shape):
            report["parted_at"] = it
            if not found:
                report["unexcused"].append(
                    {"decision": "none", "iteration": it, "excused": False,
                     "note": "the trees part, but no decision of the "
                             "iteration does"})
    report["best_tokens"] = [int(best_child(r[0])) for r in runs]
    return report
