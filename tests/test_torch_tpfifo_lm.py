"""TPFIFO LM serving on the port (``repro_torch.serve.tpfifo``'s LM half):
every case of ``tests/test_tpfifo.py`` re-run on the port, and the port held
against the JAX package on the same converted weights (reduced smollm-135m,
2 layers, float32; the JAX side runs under ``JAX_PLATFORMS=cpu``).

- grain invariance, lockstep equivalence, lossless preemption, FIFO order,
  chunked prefill and telemetry, as the JAX tests state them;
- "one compiled quantum": no kernel build across occupancies and grains
  (``kernels._build.builds``, the port's stand-in for a jit cache);
- the same trace through the JAX ``TPFIFOEngine`` and the port's gives the
  same tokens (greedy and temperature 1.0), the same per-ticket quanta
  and preemptions and the same ``QueueStats`` counts;
- ``sample_tokens`` at temperature > 0 draws ONE Gumbel field of B·V
  values from its one key, as ``jax.random.categorical`` does: a (V,)
  draw broadcast over the rows would give every row the same noise;
- ``benchmarks_torch.tpfifo`` builds the JAX twin's trace and keys.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.serve import engine as jengine
from repro.serve import tpfifo as jtpfifo
from repro_torch import convert, rng
from repro_torch.core import scheduler
from repro_torch.kernels import _build
from repro_torch.serve.engine import Request, SlotEngine
from repro_torch.serve.tpfifo import (LaneState, QueueStats, TPFIFOEngine,
                                      TPFIFOMCTSEngine, free_slot,
                                      init_lane_state, load_slot,
                                      reset_slot_rows, run_quantum,
                                      sample_tokens)
from torch_parity_util import STATS_COUNTS, ticket_log

torch.set_num_threads(1)

B, MAX_LEN = 2, 32


@pytest.fixture(scope="module")
def small_lm():
    """(JAX cfg, JAX params, port cfg, port params): the same weights."""
    jcfg = jconfigs.reduced_config("smollm-135m").replace(n_layers=2)
    jp = japi.init_params(jcfg, jax.random.key(0))
    tcfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def mixed_requests(vocab, lens=(6, 4, 9, 5, 7), max_new=5, seed=1,
                   cls=Request):
    rng_ = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng_.integers(1, vocab, size=(int(n),)
                                            ).astype(np.int32),
                max_new=max_new)
            for i, n in enumerate(lens)]


def engine(lm, **kw):
    _, _, cfg, params = lm
    kw.setdefault("grain", 4)
    return TPFIFOEngine(params, cfg, n_slots=B, max_len=MAX_LEN, eos_id=-1,
                        device="cpu", **kw)


def serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return eng.run()


def outs(done):
    return {r.rid: list(r.out) for r in done}


# ------------------------------------------------ tests/test_tpfifo.py ----
def test_fifo_order_preserved_mixed_lengths(small_lm):
    reqs = mixed_requests(512)
    eng = engine(small_lm)
    done = serve(eng, reqs)
    assert len(done) == len(reqs)
    assert eng.admission_order == [r.rid for r in reqs]
    assert all(len(r.out) == 5 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out)


def test_grain_invariance_greedy(small_lm):
    ref = None
    for grain in (1, 4, 16):
        o = outs(serve(engine(small_lm, grain=grain), mixed_requests(512)))
        ref = o if ref is None else ref
        assert o == ref, f"grain {grain} diverged"


def test_matches_lockstep_greedy(small_lm):
    """The unified micro-step path == SlotEngine's prefill+decode path,
    including the max_new=1 budget edge."""
    _, _, cfg, params = small_lm
    eng = engine(small_lm)
    lock = SlotEngine(params, cfg, n_slots=B, max_len=MAX_LEN, eos_id=-1,
                      device="cpu")
    for e in (eng, lock):
        one = mixed_requests(512, lens=(5,), max_new=1, seed=4)[0]
        one.rid = 10
        serve(e, mixed_requests(512) + [one])
    o_eng, o_lock = outs(eng.finished), outs(lock.finished)
    assert o_eng == o_lock
    assert len(o_eng[10]) == 1


def test_run_reusable_after_long_service(small_lm):
    eng = engine(small_lm)
    assert len(serve(eng, mixed_requests(512, lens=(4,), max_new=2))) == 1
    eng._ticks = 10_000            # a long-lived server
    r2 = mixed_requests(512, lens=(6,), max_new=2, seed=3)[0]
    r2.rid = 99
    done = serve(eng, [r2])
    assert done[-1].rid == 99 and len(done[-1].out) == 2


def test_preempt_resume_lossless(small_lm):
    ref = outs(serve(engine(small_lm), mixed_requests(512)))
    eng = engine(small_lm, grain=2, preempt_quanta=1)
    done = serve(eng, mixed_requests(512))
    assert eng.stats().n_preemptions > 0
    assert len(done) == 5 and outs(done) == ref


def test_one_per_core_runs_to_completion(small_lm):
    eng = engine(small_lm, policy="one_per_core", preempt_quanta=1)
    assert len(serve(eng, mixed_requests(512))) == 5
    assert eng.stats().n_preemptions == 0


def test_rebalance_widens_quanta_when_lanes_idle(small_lm):
    eng = engine(small_lm, grain=4, policy="rebalance")
    eng.submit(mixed_requests(512)[0])
    eng._admit_free_slots()
    assert eng._tick_m() == 4 * B


def test_chunked_prefill_never_blocks_short_requests(small_lm):
    r = np.random.default_rng(0)
    long_req = Request(rid=0, prompt=r.integers(1, 512, size=(24,)
                                                ).astype(np.int32), max_new=3)
    short_req = Request(rid=1, prompt=r.integers(1, 512, size=(4,)
                                                 ).astype(np.int32), max_new=3)
    done = serve(engine(small_lm, grain=2), [long_req, short_req])
    assert [x.rid for x in done] == [1, 0]
    assert len(long_req.out) == 3 and len(short_req.out) == 3


def test_no_kernel_build_across_occupancy_and_grain(small_lm):
    """No jit cache in the port: occupancy, admissions, prompt-length mixes,
    grain changes and preemption build nothing after the first quantum."""
    serve(engine(small_lm), mixed_requests(512))
    before = _build.builds
    serve(engine(small_lm, grain=7, preempt_quanta=2),
          mixed_requests(512, lens=(11,), max_new=3))
    serve(engine(small_lm, grain=2),
          mixed_requests(512, lens=(3, 12, 8), max_new=2, seed=9))
    assert _build.builds == before


def test_queue_stats_telemetry(small_lm):
    eng = engine(small_lm)
    serve(eng, mixed_requests(512))
    st = eng.stats()
    assert isinstance(st, QueueStats)
    assert st.n_finished == 5 and st.tokens == 25 and st.quanta >= 5
    assert st.throughput_tok_s > 0 and st.service_p50 > 0
    assert 0 <= st.queue_wait_p50 <= st.queue_wait_p95
    assert 0 <= st.latency_p50 <= st.latency_p95
    assert st.queue_wait_p95 > 0
    assert st.device_wait_s > 0     # the lane summary, read every tick


def test_submit_rejects_oversized_request(small_lm):
    with pytest.raises(ValueError):
        engine(small_lm).submit(Request(
            rid=0, prompt=np.arange(1, MAX_LEN - 2, dtype=np.int32),
            max_new=8))


@pytest.mark.parametrize("policy", ["fifo", "rebalance"])
@pytest.mark.parametrize("steps,grain", [(33, 8), (5, 8), (16, 4), (1, 4)])
def test_quantum_plan_covers_work_exactly(policy, steps, grain):
    plan = scheduler.quantum_plan(steps, grain, policy)
    assert sum(plan) == steps and all(m >= 1 for m in plan)
    assert scheduler.quantum_plan(33, 8, "one_per_core") == [33]


DCFG = dict(n_playouts=8, n_tasks=2, n_workers=2, branch=3, max_depth=2,
            rollout_len=2, tree_cap=64)


def mcts_engine(pkg, lm, **kw):
    jcfg, jp, tcfg, tp = lm
    if pkg == "jax":
        from repro.serve.mcts_decode import MCTSDecodeConfig
        return jtpfifo.TPFIFOMCTSEngine(jp, jcfg, MCTSDecodeConfig(**DCFG),
                                        **kw)
    from repro_torch.serve.mcts_decode import MCTSDecodeConfig
    return TPFIFOMCTSEngine(tp, tcfg, MCTSDecodeConfig(**DCFG), device="cpu",
                            **kw)


def test_tpfifo_mcts_engine_serves_queue_as_the_reference(small_lm):
    """Quanta of m search+commit rounds, preemption at quantum boundaries,
    FIFO first admissions — and the JAX engine's tokens, quanta and
    preemptions."""
    kw = dict(n_slots=2, max_prompt_len=16, grain=2, eos_id=-1,
              preempt_quanta=1)
    engs = {pkg: mcts_engine(pkg, small_lm, **kw) for pkg in ("jax", "torch")}
    cls = {"jax": jengine.Request, "torch": Request}
    for pkg, eng in engs.items():
        serve(eng, mixed_requests(512, lens=(4, 6, 5), max_new=3,
                                  cls=cls[pkg]))
    eng = engs["torch"]
    assert len(eng.finished) == 3
    assert list(dict.fromkeys(eng.admission_order)) == [0, 1, 2]
    assert all(len(r.out) == 3 for r in eng.finished)
    assert all(0 <= t < 512 for r in eng.finished for t in r.out)
    st = eng.stats()
    assert st.n_finished == 3 and st.tokens == 9
    assert_same_engines(engs["jax"], eng)


# ----------------------------------------------------- parity with JAX ----
def assert_same_engines(jeng, teng):
    assert outs(teng.finished) == outs(jeng.finished)
    assert teng.admission_order == jeng.admission_order
    assert ticket_log(teng) == ticket_log(jeng)
    js, ts = jeng.stats(), teng.stats()
    assert {k: getattr(ts, k) for k in STATS_COUNTS} == {
        k: getattr(js, k) for k in STATS_COUNTS}


@pytest.mark.parametrize("temperature,grain,preempt", [
    (0.0, 4, None), (0.0, 2, 1), (1.0, 3, None), (1.0, 2, 2)],
    ids=["greedy", "greedy-preempt", "t1", "t1-preempt"])
def test_engine_equals_reference(small_lm, temperature, grain, preempt):
    jcfg, jp, tcfg, tp = small_lm
    kw = dict(n_slots=B, max_len=MAX_LEN, grain=grain, eos_id=-1,
              preempt_quanta=preempt, temperature=temperature, seed=3)
    jeng = jtpfifo.TPFIFOEngine(jp, jcfg, **kw)
    teng = TPFIFOEngine(tp, tcfg, device="cpu", **kw)
    serve(jeng, mixed_requests(512, cls=jengine.Request))
    serve(teng, mixed_requests(512))
    assert_same_engines(jeng, teng)
    if preempt:
        assert teng.stats().n_preemptions > 0


def test_eos_retires_a_request_early(small_lm):
    """A request whose greedy stream meets ``eos_id`` retires on it, in
    both packages alike."""
    jcfg, jp, tcfg, tp = small_lm
    probe = serve(engine(small_lm), mixed_requests(512))
    eos = outs(probe)[0][2]                # request 0's third token
    kw = dict(n_slots=B, max_len=MAX_LEN, grain=3, eos_id=eos)
    jeng = jtpfifo.TPFIFOEngine(jp, jcfg, **kw)
    teng = TPFIFOEngine(tp, tcfg, device="cpu", **kw)
    serve(jeng, mixed_requests(512, cls=jengine.Request))
    serve(teng, mixed_requests(512))
    assert_same_engines(jeng, teng)
    first = {r.rid: r.out for r in teng.finished}[0]
    assert first[-1] == eos and len(first) <= 3


def test_sample_tokens_draws_one_field_from_one_key():
    r = np.random.default_rng(0)
    logits = r.normal(size=(6, 1, 512)).astype(np.float32)
    logits[:, 0, :] = logits[0, 0, :]      # equal rows: only noise differs
    key = rng.key(7, "cpu")
    got = sample_tokens(torch.from_numpy(logits), key, 1.0)
    want = jax.random.categorical(jax.random.key(7), jnp.asarray(logits),
                                  axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (6, 1) and got.dtype == torch.int32
    # one (V,) draw broadcast over the rows would sample one token six times
    assert len(set(got[:, 0].tolist())) > 1
    hot = sample_tokens(torch.from_numpy(logits * 0.5), key, 0.5)
    want = jax.random.categorical(jax.random.key(7),
                                  jnp.asarray(logits * 0.5) / 0.5, axis=-1)
    np.testing.assert_array_equal(hot.numpy(), np.asarray(want))


def test_sample_tokens_greedy_takes_the_first_maximum():
    logits = torch.zeros(3, 1, 16)
    logits[0, 0, [3, 9]] = 2.0
    logits[1, 0, 15] = 1.0
    got = sample_tokens(logits, rng.key(0, "cpu"), 0.0)
    assert got[:, 0].tolist() == [3, 15, 0]
    want = jtpfifo.sample_tokens(jnp.asarray(logits.numpy()),
                                 jax.random.key(0), 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantum_and_slot_ops_equal_reference(small_lm):
    """One quantum from the same lane state and cache: the same state and
    KV rows; load/free/reset act in place where the JAX ones donate."""
    jcfg, jp, tcfg, tp = small_lm
    L = 20
    r = np.random.default_rng(5)
    rows = r.integers(1, 512, size=(3, L)).astype(np.int32)
    tstate = init_lane_state(3, L, "cpu")
    jstate = jtpfifo.LaneState(
        tokens=jnp.zeros((3, L), jnp.int32), pos=jnp.zeros((3,), jnp.int32),
        in_tok=jnp.zeros((3,), jnp.int32), ctx_len=jnp.ones((3,), jnp.int32),
        gen=jnp.zeros((3,), jnp.int32), budget=jnp.zeros((3,), jnp.int32),
        live=jnp.zeros((3,), bool))
    for s, (ctx, budget) in enumerate([(5, 4), (9, 2), (3, 6)]):
        assert load_slot(tstate, s, torch.from_numpy(rows[s]), ctx,
                         budget) is tstate
        jstate = jtpfifo.load_slot(jstate, jnp.int32(s), jnp.asarray(rows[s]),
                                   jnp.int32(ctx), jnp.int32(budget))
    free_slot(tstate, 2)
    jstate = jtpfifo.free_slot(jstate, jnp.int32(2))
    from repro_torch.models import api as tapi
    tcache = tapi.init_cache(tcfg, 3, L, device="cpu")
    jcache = japi.init_cache(jcfg, 3, L)
    tstate, tcache = run_quantum(tp, tstate, tcache, rng.key(1, "cpu"), 7, -1,
                                 mcfg=tcfg, temperature=0.0)
    jstate, jcache = jtpfifo.run_quantum(jp, jstate, jcache,
                                         jax.random.key(1), jnp.int32(7),
                                         jnp.int32(-1), mcfg=jcfg,
                                         temperature=0.0)
    for f in LaneState._fields:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)
    np.testing.assert_allclose(tcache["stage_0"]["k"].numpy(),
                               np.asarray(jcache["stage_0"]["k"]),
                               rtol=1e-5, atol=1e-5)
    axes = (1, 1)
    mask = np.array([False, True, False])
    reset_slot_rows(tcache, mask, axes_def=axes)
    assert float(tcache["stage_0"]["k"][:, 1].abs().max()) == 0.0
    assert float(tcache["stage_0"]["v"][:, 0].abs().max()) > 0.0


# -------------------------------------------------- benchmarks_torch ----
def test_benchmark_trace_equals_reference_and_runs():
    import importlib.util
    import os
    from benchmarks_torch import tpfifo as bench
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_tpfifo_bench", os.path.join(root, "benchmarks", "tpfifo.py"))
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    args = (10, 50.0, 7, (4, 10), (16, 40), 512, 3)
    got, want = bench.make_trace(*args), jbench.make_trace(*args)
    assert [(t, r["rid"], r["max_new"]) for t, r in got] == [
        (t, r["rid"], r["max_new"]) for t, r in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a["prompt"], b["prompt"])
    out = bench.run(smoke=True, device="cpu")
    assert set(out) == {"config", "device", "lockstep", "tpfifo",
                        "policies_at_best_grain", "best_grain",
                        "best_speedup", "acceptance"}
    assert out["device"] == "cpu" and set(out["tpfifo"]) == {"8"}
    for r in (out["lockstep"], out["tpfifo"]["8"]):
        assert r["n_finished"] == 6 and r["tokens"] == 6 * 24
