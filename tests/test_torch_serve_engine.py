"""LM serving engines on the port (``repro_torch.serve.engine``) and the LM
modes of ``repro_torch.launch.serve``, held against the JAX package on the
same converted weights (reduced smollm-135m, 2 layers, float32).

- ``SlotEngine`` / ``MCTSSlotEngine`` commit the JAX engines' tokens on
  the same requests, with the same admission order and ``QueueStats``
  counts; the cases of ``tests/test_serve.py`` re-run on the port;
- ``make_prefill_step`` / ``make_serve_step`` are ``api.prefill`` /
  ``api.decode``;
- a decode step range-checks its per-row positions once, not per layer,
  and an out-of-range row still raises (JAX clamps);
- each LM mode of the launcher prints the JAX launcher's lines, times
  aside, when both serve the same weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.serve import engine as jengine
from repro.serve import mcts_decode as jmd
from repro_torch import convert, rng
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.serve import engine as tengine
from repro_torch.serve import mcts_decode as tmd
from torch_parity_util import STATS_COUNTS, ticket_log

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_lm():
    jcfg = jconfigs.reduced_config("smollm-135m").replace(n_layers=2)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def requests(cls, n=5, plen=6, max_new=5, seed=0, lens=None):
    r = np.random.default_rng(seed)
    lens = lens or [plen] * n
    return [cls(rid=i, prompt=r.integers(1, 512, size=(int(L),),
                                         dtype=np.int64).astype(np.int32),
                max_new=max_new) for i, L in enumerate(lens)]


def serve(eng, reqs):
    for q in reqs:
        eng.submit(q)
    return eng.run()


def outs(done):
    return {r.rid: list(r.out) for r in done}


def assert_same_engines(jeng, teng):
    assert outs(teng.finished) == outs(jeng.finished)
    assert teng.admission_order == jeng.admission_order
    assert ticket_log(teng) == ticket_log(jeng)
    js, ts = jeng.stats(), teng.stats()
    assert {k: getattr(ts, k) for k in STATS_COUNTS} == {
        k: getattr(js, k) for k in STATS_COUNTS}


# ------------------------------------------------------- against JAX ----
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_slot_engine_equals_reference(small_lm, temperature):
    jcfg, jp, tcfg, tp = small_lm
    kw = dict(n_slots=2, max_len=24, temperature=temperature, eos_id=-1,
              seed=5)
    lens = [6, 4, 9, 5, 7]
    jeng = jengine.SlotEngine(jp, jcfg, **kw)
    teng = tengine.SlotEngine(tp, tcfg, device="cpu", **kw)
    serve(jeng, requests(jengine.Request, lens=lens))
    serve(teng, requests(tengine.Request, lens=lens))
    assert_same_engines(jeng, teng)
    assert all(len(r.out) == 5 for r in teng.finished)


DCFG = dict(n_playouts=8, n_tasks=2, n_workers=2, branch=3, max_depth=2,
            rollout_len=2, tree_cap=64)


def test_mcts_slot_engine_equals_reference(small_lm):
    jcfg, jp, tcfg, tp = small_lm
    kw = dict(n_slots=2, max_prompt_len=12, eos_id=-1, seed=1)
    jeng = jengine.MCTSSlotEngine(jp, jcfg, jmd.MCTSDecodeConfig(**DCFG), **kw)
    teng = tengine.MCTSSlotEngine(tp, tcfg, tmd.MCTSDecodeConfig(**DCFG),
                                  device="cpu", **kw)
    lens = [4, 6, 5]
    serve(jeng, requests(jengine.Request, lens=lens, max_new=2))
    serve(teng, requests(tengine.Request, lens=lens, max_new=2))
    assert_same_engines(jeng, teng)
    assert len(teng.search_stats) == len(jeng.search_stats) == 4
    for t, j in zip(teng.search_stats, jeng.search_stats):
        assert t["best_tokens"] == j["best_tokens"]
        assert t["tree_nodes"] == j["tree_nodes"]


def test_mcts_slot_engine_first_tick_is_a_direct_batch_search(small_lm):
    """The engine's first tick commits exactly what a direct batched search
    of its token matrix, lengths, mask and first split key gives."""
    _, _, tcfg, tp = small_lm
    dcfg = tmd.MCTSDecodeConfig(**DCFG)
    eng = tengine.MCTSSlotEngine(tp, tcfg, dcfg, n_slots=3, max_prompt_len=12,
                                 eos_id=-1, seed=4, device="cpu")
    for q in requests(tengine.Request, n=2, plen=5, max_new=2):
        eng.submit(q)
    eng._admit_free_slots()
    tokens, lens = eng.tokens.copy(), eng.lens.copy()
    mask = np.array([t is not None for t in eng.active])
    _, k = rng.split(eng.key)
    _, direct = tmd.mcts_decode_search_batch(
        tp, tcfg, tokens, dcfg, k, prompt_lens=lens, request_mask=mask,
        device="cpu")
    eng.step()
    assert [r.out[0] for r in (t.req for t in eng.active[:2])] == \
        direct["best_tokens"][:2]
    assert direct["best_tokens"][2] == -1


def test_prefill_and_serve_steps_are_the_api(small_lm):
    _, _, tcfg, tp = small_lm
    toks = torch.from_numpy(np.arange(1, 9, dtype=np.int32))[None]
    got, cache = tengine.make_prefill_step(tcfg, 16)(tp, {"tokens": toks})
    want, wcache = tapi.prefill(tp, tcfg, {"tokens": toks}, 16)
    assert torch.equal(got, want)
    assert torch.equal(cache["stage_0"]["k"], wcache["stage_0"]["k"])
    step = tengine.make_serve_step(tcfg)
    nxt = torch.tensor([[3]], dtype=torch.int32)
    pos = torch.tensor([8], dtype=torch.int32)
    a, cache = step(tp, nxt, pos, cache)
    b, wcache = tapi.decode(tp, tcfg, nxt, pos, wcache)
    assert torch.equal(a, b)
    assert torch.equal(cache["stage_0"]["v"], wcache["stage_0"]["v"])
    from repro_torch.serve import tpfifo as ttpfifo
    assert tengine.sample_tokens is ttpfifo.sample_tokens   # re-exported


# ----------------------------------------------- tests/test_serve.py ----
def test_slot_engine_completes(small_lm):
    _, _, tcfg, tp = small_lm
    eng = tengine.SlotEngine(tp, tcfg, n_slots=2, max_len=48, device="cpu")
    done = serve(eng, requests(tengine.Request, max_new=5))
    assert len(done) == 5
    assert all(len(r.out) == 5 or r.out[-1] == eng.eos_id for r in done)


def test_slot_engine_greedy_matches_direct(small_lm):
    _, _, tcfg, tp = small_lm
    prompt = np.arange(1, 9, dtype=np.int32)
    eng = tengine.SlotEngine(tp, tcfg, n_slots=1, max_len=32,
                             temperature=0.0, eos_id=-1, device="cpu")
    out = serve(eng, [tengine.Request(rid=0, prompt=prompt, max_new=4)])[0].out
    logits, cache = tapi.prefill(tp, tcfg,
                                 {"tokens": torch.from_numpy(prompt)[None]}, 32)
    toks = [int(torch.argmax(logits[0, 0]))]
    for i in range(3):
        logits, cache = tapi.decode(
            tp, tcfg, torch.tensor([[toks[-1]]], dtype=torch.int32),
            torch.tensor([8 + i], dtype=torch.int32), cache)
        toks.append(int(torch.argmax(logits[0, 0])))
    assert out == toks


def test_mcts_decode_tree_growth(small_lm):
    _, _, tcfg, tp = small_lm
    dcfg = tmd.MCTSDecodeConfig(n_playouts=24, n_tasks=6, n_workers=4,
                                branch=4, max_depth=3, rollout_len=3,
                                tree_cap=128)
    tree, stats = tmd.mcts_decode_search(
        tp, tcfg, torch.arange(1, 7, dtype=torch.int32), dcfg,
        rng.key(2, "cpu"), device="cpu")
    assert stats["playouts"] == 24 and 1 < stats["tree_nodes"] <= 128
    assert stats["root_children"] <= dcfg.branch
    kids = tree.children[0][: int(tree.n_children[0])]
    assert stats["best_token"] in tree.move[kids].tolist()
    assert float(tree.visits[0]) == 24.0


def test_mcts_decode_grain_invariance(small_lm):
    _, _, tcfg, tp = small_lm
    for n_tasks in (4, 12):
        dcfg = tmd.MCTSDecodeConfig(n_playouts=24, n_tasks=n_tasks,
                                    n_workers=4, branch=4, max_depth=3,
                                    rollout_len=3, tree_cap=128)
        _, stats = tmd.mcts_decode_search(
            tp, tcfg, torch.arange(1, 7, dtype=torch.int32), dcfg,
            rng.key(3, "cpu"), device="cpu")
        assert stats["playouts"] == 24 and stats["tree_nodes"] > 1


def test_mcts_decode_prompt_len_no_kernel_build(small_lm):
    """Different prompt lengths at one matrix width build nothing (the
    JAX package's "prompt_len is traced, no recompile")."""
    from repro_torch.kernels import _build
    _, _, tcfg, tp = small_lm
    dcfg = tmd.MCTSDecodeConfig(n_playouts=8, n_tasks=2, n_workers=2,
                                branch=3, max_depth=2, rollout_len=2,
                                tree_cap=64)
    prompts = np.ones((2, 8), np.int32)
    before = _build.builds
    for lens in ([8, 8], [5, 3]):
        tmd.mcts_decode_search_batch(tp, tcfg, prompts, dcfg,
                                     rng.key(0, "cpu"), prompt_lens=lens,
                                     device="cpu")
    assert _build.builds == before


def test_mcts_slot_engine_serves_queue(small_lm):
    _, _, tcfg, tp = small_lm
    eng = tengine.MCTSSlotEngine(tp, tcfg, tmd.MCTSDecodeConfig(**DCFG),
                                 n_slots=2, max_prompt_len=12, eos_id=-1,
                                 device="cpu")
    done = serve(eng, requests(tengine.Request, n=3, plen=4, max_new=2))
    assert len(done) == 3 and all(len(r.out) == 2 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out)
    assert len(eng.search_stats) == 4      # 2 slots, 3 requests, 2 tokens


def test_mcts_slot_engine_rejects_oversized_prompt(small_lm):
    _, _, tcfg, tp = small_lm
    dcfg = tmd.MCTSDecodeConfig(n_workers=2, branch=3, max_depth=2,
                                rollout_len=2)
    eng = tengine.MCTSSlotEngine(tp, tcfg, dcfg, n_slots=1, max_prompt_len=8,
                                 device="cpu")
    with pytest.raises(ValueError):
        eng.submit(tengine.Request(rid=0, prompt=np.arange(1, 8, dtype=np.int32),
                                   max_new=4))


def test_slot_engine_rejects_oversized_prompt(small_lm):
    _, _, tcfg, tp = small_lm
    eng = tengine.SlotEngine(tp, tcfg, n_slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(tengine.Request(rid=0, prompt=np.arange(1, 10,
                                                           dtype=np.int32)))


def test_backup_values():
    from repro_torch.core.tree import init_tree
    tree = init_tree(8, 4, 1, device="cpu")
    tmd.backup_values(tree, torch.tensor([[0, 1, 8, 8], [0, 8, 8, 8]],
                                         dtype=torch.int32),
                      torch.tensor([0.5, 1.0]), torch.tensor([1.0, 1.0]))
    assert float(tree.visits[0]) == 2.0 and float(tree.wins[0]) == 1.5
    assert float(tree.visits[1]) == 1.0 and float(tree.wins[1]) == 0.5
    assert float(tree.visits[8]) == 0.0


# ------------------------------------------------------- positions ----
def test_decode_checks_row_positions_once_a_step(small_lm, monkeypatch):
    _, _, tcfg, tp = small_lm
    _, cache = tapi.prefill(tp, tcfg, {"tokens": torch.ones(
        (3, 4), dtype=torch.int32)}, 8)
    checks = []
    orig = tattn.check_positions
    monkeypatch.setattr(tattn, "check_positions",
                        lambda pos, smax: (checks.append(smax),
                                           orig(pos, smax))[1])
    tok = torch.ones((3, 1), dtype=torch.int32)
    tapi.decode(tp, tcfg, tok, torch.tensor([4, 5, 7]), cache)
    assert checks == [8]                   # once, not 2 x n_layers
    with pytest.raises(IndexError, match="outside"):
        tapi.decode(tp, tcfg, tok, torch.tensor([4, 8, 5]), cache)
    with pytest.raises(IndexError, match="outside"):
        tapi.decode(tp, tcfg, tok, torch.tensor([-1, 2, 5]), cache)
    with pytest.raises(IndexError, match="outside"):
        tapi.decode(tp, tcfg, tok, 8, cache)


# ------------------------------------------------------- the launcher ----
_TIMES = [(re.compile(r"in [0-9.]+s \([0-9.]+ tok/s"), "in T (R tok/s"),
          (re.compile(r"p50/p95 [0-9]+/[0-9]+ ms"), "p50/p95 T ms")]


def _untimed(text: str) -> str:
    for pat, sub in _TIMES:
        text = pat.sub(sub, text)
    return text


def _run_jax_main(argv):
    buf, saved = io.StringIO(), sys.argv
    sys.argv = ["prog", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = saved
    return buf.getvalue()


LM_BASE = ["--requests", "3", "--slots", "2", "--prompt-len", "8",
           "--max-new", "3", "--playouts", "8", "--tasks", "2",
           "--workers", "2", "--seed", "1"]
LM_CASES = {
    "lockstep": [],
    "lockstep-t1": ["--temperature", "1.0"],
    "tpfifo": ["--scheduler", "tpfifo", "--grain", "2",
               "--preempt-quanta", "1"],
    "mcts": ["--mcts"],
    "mcts-tpfifo": ["--mcts", "--scheduler", "tpfifo", "--grain", "1",
                    "--policy", "rebalance"],
}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_serve_launcher_lm_modes_print_the_jax_launchers_lines(case,
                                                               monkeypatch):
    """Both launchers on the same weights: the port's ``init_params`` is
    replaced by the conversion of the JAX package's draw for the seed."""
    argv = LM_BASE + LM_CASES[case]

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
    mode = ("GSCPM " if "--mcts" in argv else "") + (
        "tpfifo" if "tpfifo" in argv else "lockstep")
    assert got.startswith(f"[{mode}] served 3 requests")


def test_serve_launcher_lm_mode_writes_trace_and_metrics(tmp_path):
    from repro_torch.obsv import validate_trace
    trace, snap = tmp_path / "t.json", tmp_path / "m.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(LM_BASE + ["--scheduler", "tpfifo", "--trace", str(trace),
                               "--metrics-out", str(snap), "--device", "cpu"])
    assert validate_trace(str(trace)) > 0 and snap.exists()
    out = buf.getvalue()
    assert "trace:" in out and "metrics snapshot" in out
