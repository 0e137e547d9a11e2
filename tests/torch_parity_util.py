"""Shared helpers of the tests/test_torch_*.py parity suites: run the JAX
package and the port on the same inputs and compare trees field by field.

On a mismatch nothing is loosened: ``assert_same_search`` steps both
packages side by side, one sync iteration at a time, finds the first child
pick on which they differ and requires its top-two score gap to be below
``repro_torch.parity.TIE_GAP`` (float rounding of log/sqrt/divide is the
only thing that may differ between XLA:CPU and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import gscpm as jg
from repro.core import tree as jt
from repro.kernels import ref as jref
from repro_torch import convert, parity, rng
from repro_torch.core import gscpm as tg
from repro_torch.core import tree as tt


def jax_tree_fields(jtree) -> dict:
    return {name: np.asarray(getattr(jtree, name)) for name in jt.Tree._fields}


def tree_to_jax(ttree) -> jt.Tree:
    return jt.Tree(**{k: jnp.asarray(v)
                      for k, v in convert.tree_to_numpy(ttree).items()})


def differing(ttree, jtree) -> list[str]:
    got, want = convert.tree_to_numpy(ttree), jax_tree_fields(jtree)
    return [k for k in want
            if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k])]


def assert_trees_equal(ttree, jtree):
    assert differing(ttree, jtree) == []


def jax_keys(tkeys: torch.Tensor):
    return jax.random.wrap_key_data(
        jnp.asarray(tkeys.numpy().astype(np.uint32)))


def jax_select(wins, visits, vloss, ptot, valid, cp, noise=None,
               lane_mask=None) -> torch.Tensor:
    """The JAX package's uct_select oracle on torch tensors."""
    j = lambda x: None if x is None else jnp.asarray(x.numpy())
    out = jref.uct_select(j(wins), j(visits), j(vloss), j(ptot), j(valid),
                          jnp.float32(cp), noise=j(noise),
                          lane_mask=j(lane_mask))
    return torch.from_numpy(np.array(out))


def both_configs(**kw):
    return tg.GSCPMConfig(**kw), jg.GSCPMConfig(**kw)


def assert_same_search(board: np.ndarray, to_move: int, kw: dict, seed: int):
    """Whole gscpm_search in both packages; trees equal field by field, or
    parted at a pick within the tie gap. Returns the port's (tree, stats)."""
    tcfg, jcfg = both_configs(**kw)
    ttree, tstats = tg.gscpm_search(torch.from_numpy(board), to_move, tcfg,
                                    rng.key(seed, "cpu"), device="cpu")
    jtree, jstats = jg.gscpm_search(jnp.asarray(board), to_move, jcfg,
                                    jax.random.key(seed))
    fields = differing(ttree, jtree)
    if fields:
        explain_divergence(board, to_move, tcfg, jcfg, seed, fields)
    else:
        for k in ("playouts", "rounds", "grain", "tree_nodes", "best_move",
                  "masked_lane_fraction"):
            assert tstats[k] == jstats[k], k
        assert tstats["root_value"] == np.float32(jstats["root_value"])
    return ttree, tstats


def explain_divergence(board, to_move, tcfg, jcfg, seed, fields):
    tb, jb = torch.from_numpy(board), jnp.asarray(board)
    n_actions = tcfg.game_obj.n_actions
    ttree = tt.init_tree(tcfg.tree_cap, n_actions, to_move, device="cpu")
    jtree = jt.init_tree(jcfg.tree_cap, n_actions, to_move)
    plan = parity.iteration_plan(tcfg, rng.key(seed, "cpu"))
    for it, (iter_keys, active) in enumerate(plan):
        before = parity.clone_tree(ttree)
        tg.sync_iteration(ttree, tb, tcfg, tcfg.cp, iter_keys, active)
        jtree = jg.sync_iteration(jtree, jb, jcfg, jnp.float32(jcfg.cp),
                                  jax_keys(iter_keys),
                                  jnp.asarray(active.numpy()))
        if differing(ttree, jtree):
            pick = parity.first_divergent_pick(
                before, tb, tcfg, tcfg.cp, iter_keys, jax_select)
            assert pick is not None, (
                f"trees differ in {fields} after sync iteration {it}, but "
                "every pick of its descent agrees")
            assert pick["gap"] < parity.TIE_GAP, (
                f"port and reference part at a pick with a clear gap: {pick}")
            print(f"first divergent pick at sync iteration {it}: {pick}")
            return
    raise AssertionError(
        f"whole searches differ in {fields} but stepping them side by side "
        "found no difference")


# ------------------------------------------------------ LM decode search ----
# The LM search is held to the same standard, with one difference: its
# values come from a transformer, whose float32 logits the two packages
# compute with sums in another order (~1e-6 apart). So the tree's integer
# fields and visits must be equal, its wins (sums of exp(mean log-prob))
# equal to WINS_RTOL; and where the trees part, they must part at a decision
# (a UCT pick, the top-k order, a gumbel pick of the proposal, a rollout
# sample) whose two candidates are closer than DECISION_GAP.
from repro.core import gscpm as _jg  # noqa: E402
from repro.models import api as _japi  # noqa: E402
from repro.serve import mcts_decode as _jmd  # noqa: E402
from repro_torch.models import api as _tapi  # noqa: E402
from repro_torch.serve import mcts_decode as _tmd  # noqa: E402

WINS_RTOL = 1e-5
DECISION_GAP = 1e-5


def decode_tree_parts(ttree, jtree) -> list[str]:
    """Fields in which the two token trees part (wins to WINS_RTOL)."""
    got, want = convert.tree_to_numpy(ttree), jax_tree_fields(jtree)
    bad = []
    for k in want:
        if got[k].dtype != want[k].dtype:
            bad.append(k)
        elif k == "wins":
            if not np.allclose(got[k], want[k], rtol=WINS_RTOL, atol=1e-9):
                bad.append(k)
        elif not np.array_equal(got[k], want[k]):
            bad.append(k)
    return bad


def assert_same_decode_search(jcfg, jp, tcfg, tp, prompt: np.ndarray,
                              dkw: dict, seed: int):
    """Whole mcts_decode_search in both packages on the same weights;
    returns the port's (tree, stats)."""
    ttree, tstats = _tmd.mcts_decode_search(
        tp, tcfg, torch.from_numpy(prompt), _tmd.MCTSDecodeConfig(**dkw),
        rng.key(seed, "cpu"), device="cpu")
    jtree, jstats = _jmd.mcts_decode_search(
        jp, jcfg, jnp.asarray(prompt), _jmd.MCTSDecodeConfig(**dkw),
        jax.random.key(seed))
    fields = decode_tree_parts(ttree, jtree)
    if fields:
        explain_decode_divergence(jcfg, jp, tcfg, tp, prompt, dkw, seed, fields)
    else:
        for k in ("playouts", "tree_nodes", "best_token", "grain",
                  "root_children"):
            assert tstats[k] == jstats[k], k
    return ttree, tstats


def _port_decisions(tree, params, mcfg, cfg, cache, root, P, cp, keys, active):
    """The decisions of one port iteration, recorded by the port's own
    ``_iteration`` run on copies of the tree and cache."""
    rec: dict = {}
    _tmd._iteration(parity.clone_tree(tree), params, mcfg, cfg,
                    {s: {n: c.clone() for n, c in v.items()}
                     for s, v in cache.items()},
                    root, P, cp, keys, active, record=rec)
    rec["samples"] = torch.stack(rec["samples"], 1)
    return rec


def _jax_decisions(tree, params, mcfg, cfg, cache, root, P, cp, keys, active):
    """The same decisions from the JAX package's pieces."""
    W = cfg.n_workers
    paths, depths, leaves = _jmd.select_token_batch(
        tree, cfg, cp, jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys))
    toks = jax.vmap(lambda p: _jmd.path_tokens(tree, p, cfg.max_depth))(paths)
    leaf = jnp.broadcast_to(root, (W, root.shape[-1]))
    for t in range(cfg.max_depth):
        lg, cache = _japi.decode(params, mcfg, toks[:, t][:, None], P + t, cache)
        leaf = jnp.where((depths == t + 1)[:, None], lg[:, 0, :], leaf)
    k_prop = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
    moves = jax.vmap(lambda l, ll, d, k: _jmd.propose_token(
        tree, l, ll, cfg, d, k))(leaves, leaf, depths, k_prop)
    _, new_ids = _jg.expand_batch(tree, leaves, moves, active)
    tok = jnp.where(new_ids < tree.cap, jnp.maximum(moves, 0),
                    jnp.argmax(leaf, -1).astype(jnp.int32))
    samples = []
    for t in range(cfg.rollout_len):
        lg, cache = _japi.decode(params, mcfg, tok[:, None],
                                 P + cfg.max_depth + t, cache)
        ks = jax.vmap(lambda k: jax.random.fold_in(
            jax.random.fold_in(k, 2), t))(keys)
        tok = jax.vmap(jax.random.categorical)(
            ks, lg[:, 0, :].astype(jnp.float32) / max(cfg.temperature, 1e-6)
        ).astype(jnp.int32)
        samples.append(tok)
    t_np = lambda a: torch.from_numpy(np.array(a))
    return {"paths": t_np(paths), "top": t_np(jax.lax.top_k(leaf, cfg.branch)[1]),
            "moves": t_np(moves), "samples": t_np(jnp.stack(samples, 1))}


def _top_two(x: torch.Tensor) -> float:
    top = torch.topk(x[torch.isfinite(x)], 2).values
    return float(top[0] - top[1]) if top.numel() == 2 else float("inf")


def first_divergent_decision(tree, cfg, port: dict, ref: dict, cp, keys):
    """The first decision of one iteration on which the two packages part,
    with the gap between its two candidates in the port's numbers."""
    first = lambda m: (int(torch.nonzero(m)[0, 0]), int(torch.nonzero(m)[0, 1]))
    if not torch.equal(port["paths"], ref["paths"]):
        col, lane = first((port["paths"] != ref["paths"]).T)
        node = port["paths"][lane, col - 1].reshape(1)
        _, valid, w, v, vl, pt = tt.child_stat_tile(tree, node)
        noise = tg.level_noise(rng.fold_in(keys, 0)[lane:lane + 1],
                               torch.tensor([col - 1]), tree.max_children,
                               cfg.select_noise)
        gap = parity.top_two_gap(w, v, vl, pt, valid, cp, noise=noise)
        return {"decision": "uct_pick", "lane": lane, "level": col - 1,
                "gap": float(gap[0])}
    if not torch.equal(port["top"], ref["top"].to(torch.int32)):
        lane, i = first(port["top"] != ref["top"])
        a, b = int(port["top"][lane, i]), int(ref["top"][lane, i])
        gap = abs(float(port["leaf_logits"][lane, a]
                        - port["leaf_logits"][lane, b]))
        return {"decision": "top_k", "lane": lane, "rank": i, "gap": gap}
    if not torch.equal(port["moves"], ref["moves"]):
        lane = int(torch.nonzero(port["moves"] != ref["moves"])[0, 0])
        return {"decision": "proposal_gumbel", "lane": lane,
                "gap": _top_two(port["gumbel"][lane])}
    if not torch.equal(port["samples"], ref["samples"].to(torch.int64)):
        t, lane = first((port["samples"] != ref["samples"]).T)
        return {"decision": "rollout_sample", "lane": lane, "step": t,
                "gap": _top_two(port["scores"][t][lane])}
    return None


def explain_decode_divergence(jcfg, jp, tcfg, tp, prompt, dkw, seed, fields):
    """Step both packages one iteration at a time; at the first iteration
    after which the trees part, replay its decisions in both from the
    port's tree before it and require the first differing one to sit
    within DECISION_GAP."""
    tdc, jdc = _tmd.MCTSDecodeConfig(**dkw), _jmd.MCTSDecodeConfig(**dkw)
    P, W = len(prompt), tdc.n_workers
    max_len = P + tdc.max_depth + tdc.rollout_len + 1
    tiled = np.tile(prompt, (W, 1))
    tl, tcache = _tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tiled)},
                               max_len)
    jl, jcache = _japi.prefill(jp, jcfg, {"tokens": jnp.asarray(tiled)}, max_len)
    troot, jroot = tl[0, 0].float(), jl[0, 0].astype(jnp.float32)
    ttree = tt.init_tree(tdc.tree_cap, tdc.branch, 1, device="cpu")
    jtree = jt.init_tree(jdc.tree_cap, jdc.branch, 1)
    step = jax.jit(_jmd._iteration, static_argnums=(2, 3))
    cp = jnp.float32(tdc.cp)
    for it, (keys, active) in enumerate(
            parity.iteration_plan(tdc, rng.key(seed, "cpu"))):
        before = parity.clone_tree(ttree)
        ttree, tcache = _tmd._iteration(ttree, tp, tcfg, tdc, tcache, troot,
                                        P, tdc.cp, keys, active)
        jtree, jcache = step(jtree, jp, jcfg, jdc, jcache, jroot, jnp.int32(P),
                             cp, jax_keys(keys), jnp.asarray(active.numpy()))
        if not decode_tree_parts(ttree, jtree):
            continue
        port = _port_decisions(before, tp, tcfg, tdc, tcache, troot, P,
                               tdc.cp, keys, active)
        ref = _jax_decisions(tree_to_jax(before), jp, jcfg, jdc, jcache, jroot,
                             P, cp, jax_keys(keys), jnp.asarray(active.numpy()))
        d = first_divergent_decision(before, tdc, port, ref, tdc.cp, keys)
        assert d is not None, (
            f"trees part in {fields} after iteration {it}, but every decision "
            "of it agrees: the values themselves differ")
        assert d["gap"] < DECISION_GAP, (
            f"port and reference part at a decision with a clear gap: {d}")
        print(f"first divergent decision at sync iteration {it}: {d}")
        return d
    raise AssertionError(
        f"whole searches part in {fields} but stepping them side by side "
        "found no difference")


# ------------------------------------------------------------------ serving ----
# The serving suites (tests/test_torch_{serve_games,resilience,
# serve_pipeline,sessions}.py) run the SAME traffic through the JAX
# package's TPFIFOGameEngine and the port's (device="cpu") and compare what
# the engines answer, exactly; times are never compared.

# the answer of a served search, as both engines ship it (times excluded)
RESULT_FIELDS = ("root_visits", "root_wins", "best_move", "root_value",
                 "tree_nodes", "game", "board_size", "playouts", "rounds",
                 "rounds_total", "deadline_expired", "status", "retries",
                 "preemptions")
FOREST_FIELDS = ("n_trees", "best_move_vote", "member_best_moves")
WARM_FIELDS = ("reused_visits", "reused_nodes")
# QueueStats' counts (its times and rates are wall-clock)
STATS_COUNTS = ("n_finished", "n_preemptions", "tokens", "quanta",
                "n_retries", "n_shed", "n_quarantined", "n_unfinished")


def serving_packages():
    """{"jax": (engine module, resilience module), "torch": (...)}."""
    from repro.serve import games as jgames
    from repro.serve import resilience as jres
    from repro_torch.serve import games as tgames
    from repro_torch.serve import resilience as tres
    return {"jax": (jgames, jres), "torch": (tgames, tres)}


def make_engine(pkg: str, **kw):
    games, _ = serving_packages()[pkg]
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    return games.TPFIFOGameEngine(**kw)


def result_differences(ra: dict, rb: dict, fields=RESULT_FIELDS) -> list:
    """Fields of two served answers that differ (arrays bit for bit)."""
    bad = []
    for k in fields:
        if (k in ra) != (k in rb):
            bad.append(k)
        elif k in ra:
            a, b = ra[k], rb[k]
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                a, b = np.asarray(a), np.asarray(b)
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    bad.append(k)
            elif a != b or type(a) is not type(b):
                bad.append(k)
    return bad


def served_fields(res: dict) -> tuple:
    """Every field of an answer the engines must agree on."""
    extra = tuple(k for k in FOREST_FIELDS + WARM_FIELDS if k in res)
    return RESULT_FIELDS + extra + (("metrics",) if "metrics" in res else ())


def assert_same_serving(jeng, teng, jreqs, treqs):
    """Both engines answered the same requests the same way: every answer
    field by field, admission order, per-ticket preemptions, quanta and
    retries, and QueueStats' counts."""
    assert [r.rid for r in jreqs] == [r.rid for r in treqs]
    for jr, tr in zip(jreqs, treqs):
        assert jr.done == tr.done, jr.rid
        if jr.result is None or tr.result is None:
            assert jr.result is tr.result is None, jr.rid
            continue
        fields = served_fields(jr.result)
        assert set(fields) == set(served_fields(tr.result)), jr.rid
        assert result_differences(jr.result, tr.result, fields) == [], jr.rid
    assert jeng.admission_order == teng.admission_order
    assert ticket_log(jeng) == ticket_log(teng)
    js, ts = jeng.stats(), teng.stats()
    assert {k: getattr(js, k) for k in STATS_COUNTS} == {
        k: getattr(ts, k) for k in STATS_COUNTS}


def ticket_log(eng) -> list:
    """(rid, preemptions, quanta, retries, committed rounds) per finished
    ticket, in retirement order."""
    return [(t.req.rid, t.preemptions, t.quanta, t.retries, len(t.req.out))
            for t in eng.finished_tickets]


def port_reference(eng, r) -> dict:
    """The port's uninterrupted ``gscpm_search`` of a served request, as a
    root summary: what the quantum-served search must equal bit for bit."""
    from repro_torch.core.tree import root_summary
    cfg = eng.request_cfg(r)
    board = (cfg.game_obj.init_board("cpu") if r.board is None
             else torch.tensor(np.asarray(r.board), dtype=torch.int8))
    tree, _ = tg.gscpm_search(board, r.to_move, cfg, rng.key(r.seed, "cpu"),
                              device="cpu")
    return root_summary(tree, cfg.game_obj.n_actions)
