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
