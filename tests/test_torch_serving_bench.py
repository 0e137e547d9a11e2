"""The port's serving benchmarks (``benchmarks_torch.{serve_games,
selfplay, serve_chaos, kernels_micro}``) against the JAX package's drivers.

Each benchmark twin and its JAX driver run their smoke form on the CPU, and
every engine they drive is recorded (the drivers' own ``serve_trace`` /
``_serve_one`` / ``serve_chaos`` wrapped): the same trace, and per request
the same answer (root visits and wins, best move, value, tree nodes,
playouts, rounds) in every arm. What the drivers' wall-clock arrivals make
schedule-dependent (preemptions, ticks, which quantum a fault hits) is not
compared; what they do not (finished requests, served playouts, the fault
plans) is. The game engine's ``one_per_core`` policy is held against the
JAX engine's directly, and ``kernels_micro``'s inputs and plain outputs
against ``repro.kernels.ref`` at small shapes.
"""

from __future__ import annotations

import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_util import (assert_same_serving,
                               make_engine, result_differences,
                               serving_packages)

# the two benchmark packages live at the root of the checkout
ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import kernels_micro as jkm  # noqa: E402
from benchmarks import selfplay as jsp  # noqa: E402
from benchmarks import serve_chaos as jsc  # noqa: E402
from benchmarks import serve_games as jsg  # noqa: E402
from benchmarks_torch import kernels_micro as tkm  # noqa: E402
from benchmarks_torch import selfplay as tsp  # noqa: E402
from benchmarks_torch import serve_chaos as tsc  # noqa: E402
from benchmarks_torch import serve_games as tsg  # noqa: E402
from repro.core import game as jgame  # noqa: E402
from repro.core import hex as jhx  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

torch.set_num_threads(1)

# an answer as both engines ship it (times excluded)
ANSWER = ("root_visits", "root_wins", "best_move", "root_value",
          "tree_nodes", "playouts", "rounds", "rounds_total", "status")


def answers(reqs) -> dict:
    return {r.rid: {k: r.result[k] for k in ANSWER} for r in reqs}


def assert_same_answers(got: dict, want: dict):
    """The same requests (in any retirement order), the same answers."""
    assert sorted(got, key=str) == sorted(want, key=str)
    for rid in want:
        assert result_differences(got[rid], want[rid], ANSWER) == [], rid


def keys_cover(jax_payload: dict, port_payload: dict, path=""):
    """Every key of the JAX driver's payload is in the port's, recursively
    through the dicts whose keys are names (not request ids or rates)."""
    for k, v in jax_payload.items():
        assert k in port_payload, f"{path}{k}"
        if isinstance(v, dict) and k not in ("curves", "fired"):
            keys_cover(v, port_payload[k], f"{path}{k}.")


# ------------------------------------------------------------- serve_games --
ARMS = ("warm-up", "tpfifo", "one_per_core", "pipelined", "blocking")
# the port's driver serves one_per_core once more, with blocking retirement
PORT_ARMS = ARMS + ("one_per_core_blocking",)


def record_serve_games(mod, **kw):
    """Run ``mod.run(smoke=True)``; (payload, one answer dict per engine
    in the order the driver serves them, the engines)."""
    log, engines = [], []
    orig = mod.serve_trace

    def recording(engine, trace):
        out = orig(engine, trace)
        log.append(answers(engine.finished))
        engines.append(engine)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "serve_trace", recording)
        out = mod.run(smoke=True, **kw)
    return out, log, engines


@pytest.fixture(scope="module")
def serve_games_runs():
    return {"jax": record_serve_games(jsg),
            "torch": record_serve_games(tsg, device="cpu")}


@pytest.mark.parametrize("form", ["smoke", "card"])
@pytest.mark.parametrize("pair", ["serve_games", "serve_chaos"])
def test_make_trace_equals_jax(pair, form):
    jmod, tmod = {"serve_games": (jsg, tsg),
                  "serve_chaos": (jsc, tsc)}[pair]
    if form == "smoke":
        args = (6, 50.0, 5, (32, 64, 128), 0)
    else:
        c = tmod.CARD
        args = (16, c["rate_rps"], c["board_size"], c["playout_choices"], 0)
    assert tsg.make_trace(*args) == jmod.make_trace(*args)


@pytest.mark.parametrize("arm", range(len(ARMS)), ids=ARMS)
def test_serve_games_arm_answers_equal_jax(serve_games_runs, arm):
    (_, jlog, _), (_, tlog, _) = (serve_games_runs["jax"],
                                  serve_games_runs["torch"])
    assert len(jlog) == len(ARMS) and len(tlog) == len(PORT_ARMS)
    assert_same_answers(tlog[arm], jlog[arm])


def test_serve_games_one_per_core_equals_tpfifo(serve_games_runs):
    """The assertion the port's driver adds, held on its record: every
    request's one_per_core answer is its tpfifo answer, with pipelined and
    with blocking retirement, and the one_per_core engines never
    preempt."""
    _, log, engines = serve_games_runs["torch"]
    tp = PORT_ARMS.index("tpfifo")
    for arm in ("one_per_core", "one_per_core_blocking"):
        opc = PORT_ARMS.index(arm)
        assert_same_answers(log[opc], log[tp])
        assert engines[opc].stats().n_preemptions == 0
        assert engines[opc].policy == "one_per_core"
    assert engines[PORT_ARMS.index("one_per_core")].pipeline
    assert not engines[PORT_ARMS.index("one_per_core_blocking")].pipeline


@pytest.mark.parametrize("arm", ["tpfifo", "one_per_core"])
def test_serve_games_counts_equal_jax(serve_games_runs, arm):
    """Counts the wall-clock arrivals cannot move."""
    jout, tout = serve_games_runs["jax"][0], serve_games_runs["torch"][0]
    for k in ("n_finished", "playouts", "n_unfinished", "n_shed",
              "n_retries"):
        assert tout[arm][k] == jout[arm][k], k


def test_serve_games_payload_covers_jax(serve_games_runs):
    jout, tout = serve_games_runs["jax"][0], serve_games_runs["torch"][0]
    keys_cover(jout, tout)
    assert tout["serving"]["recompiles"] == 0
    assert tout["pipeline"]["bit_identical"] is True
    assert tout["device"] == "cpu"
    assert tout["config"]["differs_from_jax"]["board_size"] == {
        "jax": 7, "here": 5}


def test_card_forms_record_their_differences():
    """The card form of each twin departs from the JAX defaults only where
    its module says, and the payload's config would list each place."""
    assert tsg.differs_from_jax(tsg.JAX_DEFAULTS, **{
        **tsg.JAX_DEFAULTS, **tsg.CARD}) == {
        "board_size": {"jax": 7, "here": 11},
        "n_workers": {"jax": 8, "here": 256},
        "tree_cap": {"jax": 2048, "here": 1 << 17},
        "rate_rps": {"jax": 64.0, "here": 2.0},
        "playout_choices": {"jax": [128, 128, 256, 256, 512, 2048],
                            "here": [4096, 4096, 8192, 8192, 16384,
                                     65536]}}
    chaos = tsg.differs_from_jax(tsc.JAX_DEFAULTS,
                                 **{**tsc.JAX_DEFAULTS, **tsc.CARD})
    assert chaos["playout_choices"]["here"] == [4096, 4096, 8192, 8192,
                                                16384]
    assert chaos["tree_cap"]["here"] == 1 << 15
    sp = tsg.differs_from_jax(tsp.JAX_DEFAULTS,
                              **{**tsp.JAX_DEFAULTS, **tsp.CARD})
    assert set(sp) == {"n_playouts", "n_tasks", "board_size", "n_workers"}
    # the grain m = n_playouts / n_tasks stays the JAX twin's
    assert (tsp.CARD["n_playouts"] // tsp.CARD["n_tasks"]
            == tsp.JAX_DEFAULTS["n_playouts"] // tsp.JAX_DEFAULTS["n_tasks"])


# ------------------------------------------------- one_per_core, directly --
OPC_TRAFFIC = [(0, "hex", dict(n_playouts=64, n_tasks=8)),
               (1, "gomoku", dict(n_playouts=48, n_tasks=12)),
               (2, "hex", dict(n_playouts=32, n_tasks=4, cp=1.7)),
               (3, "gomoku", dict(n_playouts=64, n_tasks=16, cp=0.4)),
               (4, "hex", dict(n_playouts=16, n_tasks=16))]


def serve_both(engine_kw: dict) -> dict:
    out = {}
    for pkg in ("jax", "torch"):
        games, _ = serving_packages()[pkg]
        eng = make_engine(pkg, n_workers=4, tree_cap=512, **engine_kw)
        reqs = [games.GameRequest(rid=rid, game=g, board_size=5, seed=rid,
                                  **kw) for rid, g, kw in OPC_TRAFFIC]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[pkg] = (eng, reqs)
    return out


@functools.cache
def preempting_fifo():
    """The port's fifo engine on one slot a class, preempting after every
    quantum: (engine, requests)."""
    return serve_both(dict(n_slots=1, grain=1, preempt_quanta=1))["torch"]


@pytest.mark.parametrize("slots,grain", [(1, 1), (1, 2), (2, 2)])
def test_one_per_core_policy_equals_jax_engine(slots, grain):
    """The run-to-completion policy of ``TPFIFOGameEngine`` (each search's
    plan is one quantum) against the JAX engine's: the same answers,
    admission order, per-ticket quanta and QueueStats counts; no
    preemption; each answer equal to the fifo engine's with preemption."""
    runs = serve_both(dict(n_slots=slots, grain=grain,
                           policy="one_per_core"))
    (je, jr), (te, tr) = runs["jax"], runs["torch"]
    assert_same_serving(je, te, jr, tr)
    assert te.stats().n_preemptions == 0
    assert all(len(t.plan) == 1 for t in te.finished_tickets)
    fifo, fr = preempting_fifo()
    assert_same_answers(answers(tr), answers(fr))
    assert fifo.stats().n_preemptions > 0


# ---------------------------------------------------------------- selfplay --
def record_selfplay(mod, **kw):
    log = []
    orig = mod._serve_one

    def recording(eng, req):
        seconds = orig(eng, req)
        log.append((req.rid, {k: req.result[k] for k in ANSWER}
                    | {"reused_visits": req.result.get("reused_visits", 0)}))
        return seconds

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_serve_one", recording)
        out = mod.run(smoke=True, **kw)
    return out, log


@pytest.fixture(scope="module")
def selfplay_runs():
    return {"jax": record_selfplay(jsp),
            "torch": record_selfplay(tsp, device="cpu")}


@pytest.mark.parametrize("game", ["hex", "gomoku"])
def test_selfplay_game_equals_jax(selfplay_runs, game):
    """The same trajectory: moves, retained fractions, and every warm and
    cold answer at every position."""
    (jout, jlog), (tout, tlog) = selfplay_runs["jax"], selfplay_runs["torch"]
    jg, tg = jout["games"][game], tout["games"][game]
    assert tg["n_moves"] == jg["n_moves"] > 0
    assert tg["retained_fractions"] == jg["retained_fractions"]
    assert tg["mean_retained_fraction"] == jg["mean_retained_fraction"]
    jmoves = [a["best_move"] for rid, a in jlog
              if str(rid).startswith(f"bench-{game}#")]
    assert tg["moves"] == jmoves[:len(tg["moves"])]
    mine = lambda log: [(rid, a) for rid, a in log
                        if game in str(rid) and not str(rid).startswith(
                            "warm")]
    jl, tl = mine(jlog), mine(tlog)
    assert [rid for rid, _ in tl] == [rid for rid, _ in jl]
    for (rid, ta), (_, ja) in zip(tl, jl):
        assert result_differences(ta, ja, ANSWER) == [], rid
        assert ta["reused_visits"] == ja["reused_visits"], rid


def test_selfplay_payload_covers_jax(selfplay_runs):
    jout, tout = selfplay_runs["jax"][0], selfplay_runs["torch"][0]
    keys_cover(jout, tout)
    assert tout["selfplay"]["recompiles"] == 0
    assert tout["selfplay"]["mean_retained_fraction"] == jout["selfplay"][
        "mean_retained_fraction"]


# ------------------------------------------------------------- serve_chaos --
def record_chaos(mod, **kw):
    log = []
    orig = mod.serve_chaos

    def recording(trace, fault_rate, **kw2):
        st, reqs = orig(trace, fault_rate, **kw2)
        log.append((fault_rate, answers(reqs)))
        return st, reqs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "serve_chaos", recording)
        out = mod.run(smoke=True, **kw)
    return out, log


@pytest.fixture(scope="module")
def chaos_runs():
    return {"jax": record_chaos(jsc), "torch": record_chaos(tsc,
                                                            device="cpu")}


@pytest.mark.parametrize("point", range(3), ids=["0", "0.1", "0.3"])
def test_chaos_answers_equal_jax_at_every_rate(chaos_runs, point):
    """At rate 0 every answer equals the JAX driver's; at every rate each
    fully run answer equals the JAX driver's fault-free answer."""
    (_, jlog), (_, tlog) = chaos_runs["jax"], chaos_runs["torch"]
    assert [r for r, _ in tlog] == [r for r, _ in jlog] == [0.0, 0.1, 0.3]
    clean = jlog[0][1]
    rate, got = tlog[point]
    if rate == 0.0:
        assert_same_answers(got, clean)
    full = [rid for rid, a in got.items()
            if a["status"] == "answered" and a["rounds"] == a["rounds_total"]]
    assert full, f"rate {rate}: no fully run answer"
    for rid in full:
        assert result_differences(got[rid], clean[rid], ANSWER) == [], rid


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.2, 0.3])
def test_chaos_fault_plans_equal_jax(rate):
    plans = {pkg: res.FaultPlan.generate(seed=1234, n_ticks=4096,
                                         n_slots=4, rate=rate)
             for pkg, (_, res) in serving_packages().items()}
    ev = {pkg: [(e.tick, e.slot, e.kind) for e in p.events]
          for pkg, p in plans.items()}
    assert ev["torch"] == ev["jax"] and ev["jax"]


def test_chaos_payload_covers_jax(chaos_runs):
    jout, tout = chaos_runs["jax"][0], chaos_runs["torch"][0]
    keys_cover(jout, tout)
    c = tout["chaos"]
    assert c["recompiles"] == 0
    assert len(c["seconds"]) == len(c["device_wait_s"]) == 3
    for js, ts in zip(jout["sweep"], tout["sweep"]):
        assert ts["n_finished"] + ts["n_shed"] == js["n_finished"] + js[
            "n_shed"]
        assert ts["faults"]["planned"] == js["faults"]["planned"]


# ----------------------------------------------------------- kernels_micro --
SMALL = dict(flash_shapes=((1, 2, 1, 16, 8), (1, 2, 2, 24, 16)),
             uct_shapes=((8, 16), (32, 24)), hex_shapes=((5, 4), (7, 8)),
             gomoku_shapes=((5, 4), (7, 6)), rmsnorm_shapes=((4, 32),
                                                             (3, 130)))
J = lambda t: jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                          else t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SMALL["flash_shapes"], ids=str)
def test_kernels_micro_flash_inputs_equal_jax_ref(shape, dtype):
    q, k, v = tkm.flash_inputs(shape, dtype, 0, "cpu")
    got = tkm.ops.flash_attention(q, k, v, causal=True, layout="bhsd")
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jref.flash_attention(*(J(t).astype(jd) for t in (q, k, v)),
                                causal=True)
    # float32: summation order only; bfloat16: one rounding of the output
    tol = 2e-6 if dtype == "float32" else tkm.FLASH_TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", SMALL["uct_shapes"], ids=str)
def test_kernels_micro_uct_equals_jax_ref(shape):
    args = tkm.uct_inputs(*shape, 0, "cpu")
    got = tkm.ops.uct_select(*args, 1.0)
    want = jref.uct_select(*(J(a) for a in args), jnp.float32(1.0))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SMALL["hex_shapes"], ids=str)
def test_kernels_micro_hex_boards_equal_jax_driver(shape):
    """The playout keys and filled boards are the JAX driver's own (the
    port's threefry is jax.random's), and so are the winners."""
    size, W = shape
    empty, movers, keys, filled = tkm.hex_inputs(size, W, 0, "cpu")
    jks = jax.random.split(jax.random.fold_in(jax.random.key(0),
                                              7000 + size * W), W)
    assert np.array_equal(keys.numpy().astype(np.uint32),
                          np.asarray(jax.random.key_data(jks)))
    spec = jhx.HexSpec(size)
    jempty = jnp.tile(jhx.empty_board(spec)[None], (W, 1))
    jfilled = jhx.random_fill_batch(jempty, 1, jks, spec)
    assert np.array_equal(filled.numpy(), np.asarray(jfilled))
    assert np.array_equal(tkm.ops.hex_winner(filled, size).numpy(),
                          np.asarray(jref.hex_winner(jfilled, size)))
    assert np.array_equal(
        tkm.ops.hex_playout(empty, movers, keys, size).numpy(),
        np.asarray(jhx.playout_batch(jempty, 1, jks, spec)))


@pytest.mark.parametrize("shape", SMALL["gomoku_shapes"], ids=str)
def test_kernels_micro_gomoku_playouts_equal_jax_driver(shape):
    size, W = shape
    g = tkm.game_mod.make_game("gomoku", size)
    keys = tkm.playout_keys(size, W, 9000, 0, "cpu")
    empty = g.init_board("cpu").expand(W, -1).contiguous()
    jg = jgame.make_game("gomoku", size)
    jks = jax.random.split(jax.random.fold_in(jax.random.key(0),
                                              9000 + size * W), W)
    jempty = jnp.tile(jg.init_board()[None], (W, 1))
    assert np.array_equal(g.playout_batch(empty, 1, keys).numpy(),
                          np.asarray(jg.playout_batch(jempty, 1, jks)))


@pytest.mark.parametrize("shape", SMALL["rmsnorm_shapes"], ids=str)
def test_kernels_micro_rmsnorm_equals_jax_ref(shape):
    x, w = tkm.rmsnorm_inputs(*shape, 0, "cpu")
    got = tkm.ops.rmsnorm(x, w)
    want = jref.rmsnorm(J(x), J(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_kernels_micro_cpu_entries_are_the_plain_versions():
    """On the CPU every entry took the plain version (``dispatch:
    "plain"``, no body, zero error against itself) at every shape asked
    for, with the JAX driver's sections and playout rate."""
    out = tkm.run(device="cpu", iters=1, **SMALL)
    assert set(out) >= {"flash_attention", "uct_select", "hex_winner",
                        "gomoku_eval", "rmsnorm", "playout_eval_per_s"}
    assert len(out["flash_attention"]) == 2 * len(SMALL["flash_shapes"])
    assert list(out["hex_winner"]) == ["5x5W4", "7x7W8"]
    entries = [*out["flash_attention"].values(), *out["uct_select"].values(),
               *out["rmsnorm"].values(),
               *(e[k] for e in out["hex_winner"].values()
                 for k in ("winner", "playout"))]
    for e in entries:
        assert e["dispatch"] == "plain" and e["max_abs_err"] == 0
        assert e["bound_ms"] > 0 and e["bound_by"] in ("bytes",
                                                       "operations")
        assert e.get("body") is None
    for e in out["gomoku_eval"].values():
        assert e["batched_vs_scalar_agreement"] == 1.0
    assert out["playout_eval_per_s"] == max(
        e["playout_eval_per_s"] for e in out["hex_winner"].values())


def test_kernels_micro_shapes_are_the_jax_drivers():
    import inspect
    src = inspect.getsource(jkm.run)
    for shapes in (tkm.FLASH_SHAPES, tkm.UCT_SHAPES, tkm.HEX_SHAPES,
                   tkm.GOMOKU_SHAPES, tkm.RMSNORM_SHAPES):
        for shape in shapes:
            assert str(shape) in src, shape


def test_rmsnorm_body_names_the_two_pass_rows():
    assert tkm.rmsnorm_body(torch.float32, 1024) == "one_pass"
    assert tkm.rmsnorm_body(torch.float32, 8192) == "two_pass"
    assert tkm.rmsnorm_body(torch.bfloat16, 4096) == "one_pass"
    assert tkm.rmsnorm_body(torch.float32, 1025) == "two_pass"
