"""Serving the MoE, MLA, zamba2 and xLSTM models on the port, held against
the JAX package on the same converted weights (the reduced twins, float32).

- ``SlotEngine`` and ``TPFIFOEngine`` commit the JAX engines' greedy tokens
  on a MoE and a recurrent architecture, with more requests than slots, so
  that slots are refilled (``reset_slot_rows`` zeroes a refilled slot's
  recurrent state);
- ``mcts_decode_search`` gives the JAX package's token tree on
  ``xlstm-1.3b`` and ``zamba2-7b``: integer fields and visits equal, wins
  within the tolerance below. The recurrent blocks ignore the
  decode position, so every replay starts from the state the earlier
  iterations' paths and rollouts left in the cache, as in the reference
  (which returns its cache into the next iteration): the cache after each
  iteration equals the reference's, and it is not the prompt's state;
- ``mcts_decode_search_batch`` on ``xlstm-1.3b``: the padded (B, P)
  prefill feeds pad tokens into the shorter rows' state and the root
  decode feeds their last prompt token again, as in the reference;
- each of the four architectures is served by ``repro_torch.launch.serve``
  in lockstep, TPFIFO and search-guided modes with the JAX launcher's
  printed lines (the same requests and tokens), times aside; without
  ``--device cpu`` it asks for CUDA; the vlm and encdec ids, which the
  JAX launcher fails on, are refused naming the input they need.

Tolerances: the zamba2 and MoE twins' trees to ``WINS_RTOL`` (1e-5). The
xLSTM twin has 16 layers, whose logits part from the reference's by up to
~2e-5 of the largest (``tests/test_torch_families.py``): its rollout values
(exp of a mean log-probability) part by up to ~1.3e-5 relative, so its wins
are held to ``WINS_RTOL_DEEP``, and every cache leaf of either recurrent
twin after an iteration to ``CACHE_TOL`` of the largest reference value.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import tree as jt
from repro.models import api as japi
from repro.serve import engine as jengine
from repro.serve import mcts_decode as jmd
from repro.serve import tpfifo as jtpfifo
from repro_torch import convert, parity, rng
from repro_torch.core import tree as tt
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models.common import tree_leaves
from repro_torch.serve import engine as tengine
from repro_torch.serve import mcts_decode as tmd
from repro_torch.serve import tpfifo as ttpfifo
from torch_parity_util import (STATS_COUNTS, WINS_RTOL,
                               assert_same_decode_search, decode_tree_parts,
                               jax_keys, ticket_log)

torch.set_num_threads(1)

CACHE_TOL = 1e-4
WINS_RTOL_DEEP = 1e-4


def wins_rtol(arch: str) -> float:
    return WINS_RTOL_DEEP if arch == "xlstm-1.3b" else WINS_RTOL


def pair(arch: str, seed: int = 0):
    jcfg = jconfigs.reduced_config(arch)
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    jp = japi.init_params(jcfg, jax.random.key(seed))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=["qwen3-moe-235b-a22b", "xlstm-1.3b"])
def lm(request):
    return pair(request.param)


def requests(cls, lens, max_new=4, seed=0):
    r = np.random.default_rng(seed)
    return [cls(rid=i, prompt=r.integers(1, 512, size=(int(L),)).astype(
        np.int32), max_new=max_new) for i, L in enumerate(lens)]


def serve(eng, reqs):
    for q in reqs:
        eng.submit(q)
    return eng.run()


def assert_same_engines(jeng, teng):
    outs = lambda eng: {r.rid: list(r.out) for r in eng.finished}
    assert outs(teng) == outs(jeng)
    assert teng.admission_order == jeng.admission_order
    assert ticket_log(teng) == ticket_log(jeng)
    js, ts = jeng.stats(), teng.stats()
    assert {k: getattr(ts, k) for k in STATS_COUNTS} == {
        k: getattr(js, k) for k in STATS_COUNTS}


LENS = [6, 4, 9, 5]


def test_slot_engine_equals_reference(lm):
    jcfg, jp, tcfg, tp = lm
    kw = dict(n_slots=2, max_len=16, eos_id=-1, seed=5)
    jeng = jengine.SlotEngine(jp, jcfg, **kw)
    teng = tengine.SlotEngine(tp, tcfg, device="cpu", **kw)
    serve(jeng, requests(jengine.Request, LENS))
    serve(teng, requests(tengine.Request, LENS))
    assert_same_engines(jeng, teng)
    assert all(len(r.out) == 4 for r in teng.finished)


def test_tpfifo_engine_equals_reference(lm):
    """Chunked prefill through the quantum, refilled slots, a preemption."""
    jcfg, jp, tcfg, tp = lm
    kw = dict(n_slots=2, max_len=16, grain=3, eos_id=-1, preempt_quanta=2,
              seed=3)
    jeng = jtpfifo.TPFIFOEngine(jp, jcfg, **kw)
    teng = ttpfifo.TPFIFOEngine(tp, tcfg, device="cpu", **kw)
    serve(jeng, requests(jengine.Request, LENS))
    serve(teng, requests(tengine.Request, LENS))
    assert_same_engines(jeng, teng)
    assert teng.stats().n_preemptions > 0


def test_reset_slot_rows_zeroes_recurrent_state_as_reference():
    """A refilled slot's nested recurrent leaves (mLSTM C/n/m/conv, sLSTM
    h/c/n/m/conv) are zeroed along each leaf's batch axis, the others'
    kept, as the JAX package's ``reset_slot_rows`` does."""
    jcfg, jp, tcfg, tp = pair("xlstm-1.3b")
    toks = np.random.default_rng(1).integers(1, 512, (3, 5)).astype(np.int32)
    _, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 8)
    _, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, 8)
    axes = ttpfifo.cache_batch_axes(tcfg, 3, 8)
    assert axes == tuple(jax.tree.leaves(japi.cache_batch_axes(jcfg, 3, 8)))
    assert sorted(set(axes)) == [1, 2]
    mask = np.array([False, True, False])
    jc = jtpfifo.reset_slot_rows(jc, jnp.asarray(mask), axes_def=axes)
    assert ttpfifo.reset_slot_rows(tc, mask, axes_def=axes) is tc
    for (path, t), j, bi in zip(tree_leaves(tc), jax.tree.leaves(jc), axes):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=CACHE_TOL,
                                   atol=CACHE_TOL * float(np.abs(j).max()),
                                   err_msg=path)
        assert not t.select(bi, 1).any() and t.select(bi, 0).any(), path


# ------------------------------------------------------ search trees ----
DKW = dict(n_playouts=24, n_tasks=6, n_workers=4, branch=4, max_depth=3,
           rollout_len=3, tree_cap=128)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_decode_search_tree_equals_reference(arch):
    jcfg, jp, tcfg, tp = pair(arch, 1)
    prompt = np.random.default_rng(7).integers(1, 512, 6).astype(np.int32)
    tree, stats = assert_same_decode_search(jcfg, jp, tcfg, tp, prompt, DKW,
                                            seed=4, wins_rtol=wins_rtol(arch))
    assert stats["tree_nodes"] > 1 and stats["playouts"] == 24


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_search_carries_recurrent_state_across_iterations(arch):
    """Each iteration replays its paths from whatever state the cache holds:
    after every iteration the port's cache equals the reference's, and the
    recurrent leaves are no longer the prompt's state (nothing restores
    it), where the attention K/V of the prompt are kept."""
    jcfg, jp, tcfg, tp = pair(arch, 2)
    cfg = tmd.MCTSDecodeConfig(**DKW)
    jdc = jmd.MCTSDecodeConfig(**DKW)
    prompt = np.random.default_rng(8).integers(1, 512, 6).astype(np.int32)
    P, W = len(prompt), cfg.n_workers
    max_len = P + cfg.max_depth + cfg.rollout_len + 1
    tiled = np.tile(prompt, (W, 1))
    tl, tcache = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tiled)},
                              max_len)
    jl, jcache = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(tiled)},
                              max_len)
    prompt_state = {k: v.clone() for k, v in tree_leaves(tcache)}
    troot, jroot = tl[0, 0].float(), jl[0, 0].astype(jnp.float32)
    ttree = tt.init_tree(cfg.tree_cap, cfg.branch, 1, device="cpu")
    jtree = jt.init_tree(jdc.tree_cap, jdc.branch, 1)
    step = jax.jit(jmd._iteration, static_argnums=(2, 3))
    plan = list(parity.iteration_plan(cfg, rng.key(4, "cpu")))[:3]
    for keys, active in plan:
        ttree, tcache = tmd._iteration(ttree, tp, tcfg, cfg, tcache, troot, P,
                                       cfg.cp, keys, active)
        jtree, jcache = step(jtree, jp, jcfg, jdc, jcache, jroot, jnp.int32(P),
                             jnp.float32(cfg.cp), jax_keys(keys),
                             jnp.asarray(active.numpy()))
        assert decode_tree_parts(ttree, jtree, wins_rtol(arch)) == []
        want = {".".join(str(k.key) for k in p): v for p, v in
                jax.tree_util.tree_leaves_with_path(jcache)}
        for name, t in tree_leaves(tcache):
            j = np.asarray(want[name], np.float32)
            err = float(np.abs(t.float().numpy() - j).max())
            assert err <= CACHE_TOL * max(float(np.abs(j).max()), 1e-30), name
    moved = [name for name, t in tree_leaves(tcache)
             if not torch.equal(t, prompt_state[name])]
    recurrent = [name for name in prompt_state
                 if name.rsplit(".", 1)[-1] not in ("k", "v")]
    assert set(recurrent) <= set(moved)
    final = dict(tree_leaves(tcache))
    for name in set(prompt_state) - set(recurrent):   # the prompt's K/V rows
        assert torch.equal(final[name][..., :P, :, :],
                           prompt_state[name][..., :P, :, :]), name


def test_batch_search_on_a_recurrent_model_equals_reference():
    """Prompts of lengths 6 / 4 / 5 left-aligned in one matrix: the shorter
    rows' states take the pad tokens, then the root decode at ``lens - 1``
    feeds their last prompt token again, as in the reference."""
    jcfg, jp, tcfg, tp = pair("xlstm-1.3b", 3)
    prompts = np.zeros((3, 6), np.int32)
    prompts[0] = np.arange(1, 7)
    prompts[1, :4] = np.arange(2, 6)
    prompts[2, :5] = 7
    lens = np.array([6, 4, 5], np.int32)
    forest, stats = tmd.mcts_decode_search_batch(
        tp, tcfg, prompts, tmd.MCTSDecodeConfig(**DKW), rng.key(2, "cpu"),
        prompt_lens=lens, device="cpu")
    jforest, jstats = jmd.mcts_decode_search_batch(
        jp, jcfg, jnp.asarray(prompts), jmd.MCTSDecodeConfig(**DKW),
        jax.random.key(2), prompt_lens=jnp.asarray(lens))
    for b in range(3):
        assert decode_tree_parts(tt.forest_member(forest, b),
                                 jax.tree.map(lambda x: x[b], jforest),
                                 WINS_RTOL_DEEP) == []
    assert stats["best_tokens"] == jstats["best_tokens"]


# ---------------------------------------------------------- launcher ----
def _untimed(text: str) -> str:
    import re
    for pat, sub in [(r"in [0-9.]+s \([0-9.]+ tok/s", "in T (R tok/s"),
                     (r"p50/p95 [0-9]+/[0-9]+ ms", "p50/p95 T ms")]:
        text = re.sub(pat, sub, text)
    return text


def _run_jax_main(argv):
    import sys
    from repro.launch import serve as jserve
    buf, saved = io.StringIO(), sys.argv
    sys.argv = ["prog", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = saved
    return buf.getvalue()


LAUNCH_BASE = ["--requests", "2", "--slots", "2", "--prompt-len", "8",
               "--max-new", "2", "--playouts", "8", "--tasks", "2",
               "--workers", "2", "--seed", "1"]
LAUNCH_MODES = {"lockstep": [], "tpfifo": ["--scheduler", "tpfifo"],
                "mcts": ["--mcts"]}


@pytest.mark.parametrize("mode", list(LAUNCH_MODES))
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b",
                                  "zamba2-7b", "xlstm-1.3b"])
def test_launcher_serves_the_family_as_the_jax_launcher(arch, mode,
                                                        monkeypatch):
    """``--arch`` with each mode: the JAX launcher's lines (the same
    requests and tokens) on the same weights (the port's ``init_params``
    replaced by the conversion of the JAX package's draw for the seed)."""
    argv = ["--arch", arch, *LAUNCH_BASE, *LAUNCH_MODES[mode]]

    def jax_weights(cfg, seed=0, device=None):
        jcfg = jconfigs.reduced_config(cfg.name.removesuffix("-reduced"))
        jp = japi.init_params(jcfg, jax.random.key(seed))
        return convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device)

    monkeypatch.setattr(tapi, "init_params", jax_weights)
    want = _run_jax_main(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main([*argv, "--device", "cpu"])
    got = buf.getvalue()
    assert _untimed(got) == _untimed(want)
    assert " served 2 requests" in got


@pytest.mark.parametrize("arch,needs,jax_error", [
    ("paligemma-3b", "patches", AttributeError),
    ("seamless-m4t-medium", "frames", KeyError)])
def test_launcher_refuses_vlm_and_encdec_naming_the_input(arch, needs,
                                                          jax_error,
                                                          monkeypatch,
                                                          capsys):
    """The JAX launcher fails on these archs (its engines prefill tokens
    only: no patches, no frames); the port's launcher refuses them before
    any model is built, naming the missing input, not an item of the
    roadmap."""
    argv = ["--arch", arch, *LAUNCH_BASE]
    with pytest.raises(jax_error):
        _run_jax_main(argv)
    built = []
    monkeypatch.setattr(tapi, "init_params", lambda *a, **kw: built.append(a))
    with pytest.raises(SystemExit) as e:
        tserve.main([*argv, "--device", "cpu"])
    assert e.value.code == 2 and built == []
    err = capsys.readouterr().err
    assert f"--arch {arch}" in err and f"`{needs}`" in err
    assert "A12" not in err


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b",
                                  "zamba2-7b", "xlstm-1.3b"])
def test_launcher_asks_for_cuda_without_device_cpu(arch):
    """Without ``--device cpu`` the launcher means the GPU, for every
    family: here, with none, torch raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it has none")
    with pytest.raises((AssertionError, RuntimeError)):
        tserve.main(["--arch", arch, "--requests", "1"])
