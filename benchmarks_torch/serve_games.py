"""Mixed-game Poisson serving through the TPFIFO quantum engine, on the port.

The torch twin of ``benchmarks/serve_games.py``: Hex and Gomoku search
requests with mixed playout budgets arrive Poisson and are served in m-round
GSC-PM quanta from per-game-class slot pools
(``repro_torch.serve.games``), against the ``one_per_core``
run-to-completion engine (the paper's one-task-per-lane discipline) on the
same trace; then pipelined against blocking retirement on the same trace,
and one_per_core once more with blocking retirement (see ``run``).

The same ``make_trace``, arms, result keys and assertions as the JAX twin:
pipelined answers equal blocking answers request by request, and serving
the whole trace builds nothing after the one-request-per-class warm-up (the
port has no jit cache; its ledger is the kernel library's build counter,
``obsv.trace.kernel_builds``, reported under ``serving.recompiles``). One
assertion more, which the JAX twin's invariant implies: every request's
``one_per_core`` answer equals its ``tpfifo`` answer, because a search's
round randomness depends only on its key and task ids, not on how its
rounds are cut into quanta.

``run()``'s defaults are the JAX twin's; ``CARD`` is the form
``benchmarks_torch.run`` measures on the GPU (11x11 for both classes, 256
lanes, budgets 32x the JAX twin's), and the payload's
``config.differs_from_jax`` lists every place where a run departs from the
JAX defaults.

    PYTHONPATH=src python -m benchmarks_torch.serve_games [--smoke|--full] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.obsv.trace import kernel_builds
from repro_torch.serve.games import GameRequest, TPFIFOGameEngine

from benchmarks_torch.common import device_stamp, resolve_device, save_result

GAMES = ("hex", "gomoku")

# the JAX twin's run() defaults (benchmarks/serve_games.py)
JAX_DEFAULTS = dict(n_requests=16, slots=2, grain=2, n_workers=8,
                    board_size=7, rate_rps=64.0, preempt_quanta=2,
                    tree_cap=1 << 11,
                    playout_choices=(128, 128, 256, 256, 512, 2048), seed=0)
# the card's form: one engine clears ~1.1 requests/s of 17,749 playouts
# on average, so at 2 requests/s a queue forms, as in the JAX twin's run
CARD = dict(board_size=11, n_workers=256, tree_cap=1 << 17, rate_rps=2.0,
            playout_choices=tuple(32 * n for n in
                                  JAX_DEFAULTS["playout_choices"]))


def make_trace(n_requests: int, rate_rps: float, board_size: int,
               playout_choices, seed: int):
    """Poisson arrivals, alternating game classes, mixed budgets/Cp/seeds."""
    rng = np.random.default_rng(seed)
    trace, t = [], 0.0
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        npo = int(rng.choice(playout_choices))
        trace.append((t, dict(
            rid=rid, game=GAMES[rid % len(GAMES)], board_size=board_size,
            n_playouts=npo, n_tasks=max(1, npo // 8),
            cp=float(rng.uniform(0.8, 1.4)), seed=rid)))
    return trace


def _requests(trace):
    return [(t, GameRequest(**kw)) for t, kw in trace]


def serve_trace(engine, trace) -> dict:
    done = engine.run_trace(_requests(trace))
    st = engine.stats()
    assert st.n_finished == len(trace), \
        f"only {st.n_finished}/{len(trace)} requests finished"
    out = st.as_dict()
    playouts = sum(r.result["playouts"] for r in done)
    out["playouts"] = playouts
    out["playouts_per_s"] = playouts / max(out["wall_s"], 1e-9)
    out["ticks"] = engine._ticks
    return out


def differs_from_jax(defaults: dict, **kw) -> dict:
    """{knob: {"jax": default, "here": value}} for every knob of this run
    that is not the JAX twin's default (``defaults``)."""
    def norm(v):
        return list(v) if isinstance(v, tuple) else v
    return {k: {"jax": norm(v), "here": norm(kw[k])}
            for k, v in defaults.items()
            if k in kw and norm(kw[k]) != norm(v)}


def assert_same_answers(a: TPFIFOGameEngine, b: TPFIFOGameEngine,
                        what: str) -> None:
    """Request by request, root visits and best move equal."""
    res_b = {r.rid: r.result for r in b.finished}
    for r in a.finished:
        want = res_b[r.rid]
        assert np.array_equal(r.result["root_visits"], want["root_visits"]), \
            f"{what}: request {r.rid} root visits differ"
        assert r.result["best_move"] == want["best_move"], \
            f"{what}: request {r.rid} best move differs"


def run(n_requests: int = 16, slots: int = 2, grain: int = 2,
        n_workers: int = 8, board_size: int = 7, rate_rps: float = 64.0,
        preempt_quanta: int | None = 2, tree_cap: int = 1 << 11,
        playout_choices=(128, 128, 256, 256, 512, 2048), seed: int = 0,
        smoke: bool = False, device=None) -> dict:
    if smoke:
        n_requests, board_size, tree_cap = 6, 5, 512
        playout_choices, rate_rps = (32, 64, 128), 50.0
    device = resolve_device(device)
    playout_choices = tuple(playout_choices)

    trace = make_trace(n_requests, rate_rps, board_size, playout_choices,
                       seed)

    def engine(policy="fifo", preempt=preempt_quanta, pipeline=None):
        return TPFIFOGameEngine(n_slots=slots, grain=grain, policy=policy,
                                preempt_quanta=preempt, n_workers=n_workers,
                                tree_cap=tree_cap, pipeline=pipeline,
                                device=device)

    # builds and allocator set-up off the clock: one tiny request per game
    # class runs every op each class ever runs
    warm = [(0.0, dict(rid=f"warm-{g}", game=g, board_size=board_size,
                       n_playouts=8, n_tasks=2, seed=0)) for g in GAMES]
    serve_trace(engine(), warm)
    builds_before = kernel_builds()

    eng_fifo = engine()
    tpfifo = serve_trace(eng_fifo, trace)
    eng_opc = engine(policy="one_per_core", preempt=None)
    one_per_core = serve_trace(eng_opc, trace)
    assert_same_answers(eng_opc, eng_fifo, "one_per_core vs tpfifo")

    p50_ratio = one_per_core["latency_p50"] / max(tpfifo["latency_p50"],
                                                  1e-9)
    p95_ratio = one_per_core["latency_p95"] / max(tpfifo["latency_p95"],
                                                  1e-9)

    # pipelined vs blocking retirement: same trace, same answers (asserted
    # per request), throughput and host-blocked-on-device time side by side
    eng_on, eng_off = engine(pipeline=True), engine(pipeline=False)
    pipe_on = serve_trace(eng_on, trace)
    pipe_off = serve_trace(eng_off, trace)
    assert_same_answers(eng_on, eng_off, "pipelined vs blocking")
    # one_per_core again with blocking retirement: a pipelined engine
    # stamps a retirement after the NEXT tick's quanta are dispatched, and
    # here dispatching is the host's launches, so a tick is host time; a
    # one_per_core tick spans whole searches, which a fifo tick of grain
    # rounds does not. Blocking on both sides compares the disciplines
    # alone.
    eng_opc_off = engine(policy="one_per_core", preempt=None, pipeline=False)
    one_per_core_blocking = serve_trace(eng_opc_off, trace)
    assert_same_answers(eng_opc_off, eng_fifo,
                        "one_per_core blocking vs tpfifo")
    recompiles = kernel_builds() - builds_before
    assert recompiles == 0, \
        f"mixed-budget serving built the kernel library {recompiles} times"
    pipeline = {
        "pipelined_playouts_per_s": pipe_on["playouts_per_s"],
        "blocking_playouts_per_s": pipe_off["playouts_per_s"],
        "speedup": (pipe_on["playouts_per_s"]
                    / max(pipe_off["playouts_per_s"], 1e-9)),
        "pipelined_device_wait_s": pipe_on["device_wait_s"],
        "blocking_device_wait_s": pipe_off["device_wait_s"],
        "bit_identical": True,
    }
    knobs = dict(n_requests=n_requests, slots=slots, grain=grain,
                 n_workers=n_workers, board_size=board_size,
                 rate_rps=rate_rps, preempt_quanta=preempt_quanta,
                 tree_cap=tree_cap, playout_choices=playout_choices,
                 seed=seed)
    return {
        "config": {**knobs, "playout_choices": list(playout_choices),
                   "smoke": smoke, "differs_from_jax": differs_from_jax(
                       JAX_DEFAULTS, **knobs)},
        "device": device_stamp(device),
        "tpfifo": tpfifo,
        "one_per_core": one_per_core,
        "one_per_core_blocking": one_per_core_blocking,
        "blocking": pipe_off,
        "one_per_core_equals_tpfifo": True,
        "pipeline": pipeline,
        "serving": {
            "games": list(GAMES),
            "board": f"{board_size}x{board_size}",
            "n_requests": n_requests,
            "playouts_per_s": tpfifo["playouts_per_s"],
            "move_latency_p50_s": tpfifo["latency_p50"],
            "move_latency_p95_s": tpfifo["latency_p95"],
            "one_per_core_playouts_per_s": one_per_core["playouts_per_s"],
            "p50_vs_one_per_core": p50_ratio,
            "p95_vs_one_per_core": p95_ratio,
            # both arms with blocking retirement
            "blocking_p50_vs_one_per_core": (
                one_per_core_blocking["latency_p50"]
                / max(pipe_off["latency_p50"], 1e-9)),
            "blocking_p95_vs_one_per_core": (
                one_per_core_blocking["latency_p95"]
                / max(pipe_off["latency_p95"], 1e-9)),
            "preemptions": tpfifo["n_preemptions"],
            "recompiles": recompiles,
        },
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true",
                   help="tiny trace (a check that it runs)")
    p.add_argument("--full", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda")
    args = p.parse_args(argv)

    n = 32 if args.full else 16
    out = (run(smoke=True, device=args.device) if args.smoke
           else run(**CARD, n_requests=n, device=args.device))
    for name in ("tpfifo", "one_per_core"):
        r = out[name]
        print(f"{name:>12}: {r['playouts_per_s']:10.0f} playouts/s   "
              f"p50/p95 move latency {r['latency_p50']*1e3:6.0f}/"
              f"{r['latency_p95']*1e3:6.0f} ms   "
              f"preempts {r['n_preemptions']}")
    s = out["serving"]
    print(f"one_per_core / tpfifo latency: p50 {s['p50_vs_one_per_core']:.2f}x"
          f"  p95 {s['p95_vs_one_per_core']:.2f}x (both blocking: "
          f"{s['blocking_p50_vs_one_per_core']:.2f}x / "
          f"{s['blocking_p95_vs_one_per_core']:.2f}x)   "
          f"recompiles during serving: {s['recompiles']}")
    pl = out["pipeline"]
    print(f"pipelined vs blocking: {pl['speedup']:.2f}x playouts/s   "
          f"device wait {pl['pipelined_device_wait_s']*1e3:.1f} / "
          f"{pl['blocking_device_wait_s']*1e3:.1f} ms   bit-identical: "
          f"{pl['bit_identical']}")
    print("->", save_result("serve_games", out))
    return out


if __name__ == "__main__":
    main()
