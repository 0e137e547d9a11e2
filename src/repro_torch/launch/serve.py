"""Serving launcher (port of ``repro.launch.serve``): continuous-batched
decode, GSCPM decoding, and board-game search.

``python -m repro_torch.launch.serve --requests 8`` serves synthetic
prompts on the GPU through the lockstep slot engine (``SlotEngine``);
``--scheduler tpfifo`` swaps in the work-sharing TPFIFO queue
(grain-size-controlled continuous batching, DESIGN.md §10) and ``--mcts``
decodes with Grain-Size Controlled MCTS instead of greedy sampling
(``MCTSSlotEngine`` / ``TPFIFOMCTSEngine``). As in the JAX launcher the
model is ``configs.reduced_config(--arch)`` with random weights from
``--seed`` (``api.init_params``; not the JAX package's bits).

``--mcts-game {hex,gomoku,mixed}`` serves board-game SEARCH requests
instead: ``GameRequest``s through the TPFIFO quantum engine's
per-game-class slot pools (``repro_torch.serve.games``; DESIGN.md §14),
Hex and Gomoku alternating under ``mixed``; ``--scheduler`` may be left
out there (the game engine is the TPFIFO one) or given as ``tpfifo``, as
the JAX launcher requires.

The flags and the printed lines are the JAX launcher's, plus ``--device``
(default ``cuda``); ``--device cpu`` runs the same traffic with the
kernels' plain PyTorch versions. The vlm and encoder-decoder archs
(``paligemma-3b``, ``seamless-m4t-medium``) are refused before any model is
built: their prefill needs stub patch or frame embeddings, which this
launcher's synthetic traffic does not carry (the JAX launcher fails on
them too).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def make_observers(args):
    """--trace / --metrics-out -> (TraceRecorder | None, Registry | None)."""
    tracer = registry = None
    if args.trace:
        from repro_torch.obsv import TraceRecorder
        tracer = TraceRecorder(process_name="repro-serve")
    if args.metrics_out:
        from repro_torch.obsv import MetricsRegistry
        registry = MetricsRegistry()
    return tracer, registry


def finish_observers(args) -> None:
    """Write (and structurally validate) the observability artifacts."""
    if args.tracer is not None:
        from repro_torch.obsv import validate_trace
        path = args.tracer.save(args.trace)
        n = validate_trace(path)
        print(f"  trace: {n} events -> {path} "
              f"(open in chrome://tracing or ui.perfetto.dev)")
    if args.registry is not None:
        print(f"  metrics snapshot -> {args.registry.save(args.metrics_out)}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--scheduler", default=None,
                   choices=["lockstep", "tpfifo"],
                   help="lockstep (the LM default): one decode step per "
                        "tick; tpfifo: work-sharing FIFO queue dispatching "
                        "grain-sized quanta (chunked prefill + continuous "
                        "batching); game serving runs on the TPFIFO engine")
    p.add_argument("--grain", type=int, default=8,
                   help="micro-steps (game serving: schedule rounds) per "
                        "TPFIFO dispatch quantum")
    p.add_argument("--policy", default="fifo",
                   choices=["fifo", "rebalance", "one_per_core"],
                   help="TPFIFO admission/requeue discipline")
    p.add_argument("--preempt-quanta", type=int, default=None,
                   help="preempt+requeue a request after this many quanta")
    p.add_argument("--mcts", action="store_true",
                   help="decode with GSCPM search instead of greedy")
    p.add_argument("--mcts-game", default=None,
                   choices=["hex", "gomoku", "mixed"],
                   help="serve board-game search requests (no LM) through "
                        "the TPFIFO game engine; 'mixed' alternates classes")
    p.add_argument("--board-size", type=int, default=7)
    p.add_argument("--deadline", type=float, default=None,
                   help="per-request time-to-move deadline in seconds")
    p.add_argument("--playouts", type=int, default=64)
    p.add_argument("--tasks", type=int, default=16)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="record a Chrome/Perfetto trace of the serve run "
                        "(admissions, quanta, preemptions, deadline "
                        "expiries, kernel builds) to this file")
    p.add_argument("--metrics-out", default=None, metavar="OUT.json",
                   help="write a MetricsRegistry counter/gauge snapshot "
                        "(JSON) at the end of the run")
    p.add_argument("--device-metrics", action="store_true",
                   help="thread the device-plane SearchMetrics accumulator "
                        "through every served search (results stay "
                        "bit-identical)")
    p.add_argument("--chaos-rate", type=float, default=0.0,
                   help="inject a seeded Bernoulli fault plan at this "
                        "per-(tick,slot) rate — dispatch errors, NaN "
                        "poisoning, clock stalls, duplicate submissions "
                        "(DESIGN.md §17)")
    p.add_argument("--chaos-seed", type=int, default=0,
                   help="fault-plan seed: same seed, same fault sequence")
    p.add_argument("--max-queue", type=int, default=None,
                   help="bounded admission: shed requests beyond this many "
                        "queued per game class (status='shed')")
    p.add_argument("--quarantine-after", type=int, default=None,
                   help="quarantine a slot after this many consecutive "
                        "quantum failures (the engine serves on survivors)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and the searches "
                        "(default: cuda, which raises without a GPU)")
    args = p.parse_args(argv)

    if args.mcts_game:
        if args.scheduler == "lockstep":
            p.error("--mcts-game requires --scheduler tpfifo "
                    "(game serving runs on the quantum engine)")
        args.tracer, args.registry = make_observers(args)
        serve_games(args)
        return
    from repro_torch import configs
    family = configs.get_config(args.arch).family
    needs = {"vlm": "patches", "encdec": "frames"}.get(family)
    if needs:
        # the engines serve token prompts only, as in the JAX launcher
        # (which fails on these archs once the model is built)
        p.error(f"--arch {args.arch}: the {family} family needs a `{needs}` "
                "input, which the launcher's synthetic token traffic does "
                "not carry; call models.api.prefill or "
                "serve.mcts_decode.mcts_decode_search with it")
    args.scheduler = args.scheduler or "lockstep"
    args.tracer, args.registry = make_observers(args)
    serve_lm(args)


def serve_lm(args) -> None:
    """Synthetic LM traffic through the lockstep or TPFIFO slot engines,
    greedy/temperature sampling or GSCPM decoding."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serve.engine import MCTSSlotEngine, Request, SlotEngine
    from repro_torch.serve.mcts_decode import MCTSDecodeConfig
    from repro_torch.serve.tpfifo import TPFIFOEngine, TPFIFOMCTSEngine

    cfg = configs.reduced_config(args.arch)
    params = api.init_params(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    obs = dict(tracer=args.tracer, registry=args.registry, device=args.device)

    if args.mcts:
        dcfg = MCTSDecodeConfig(n_playouts=args.playouts, n_tasks=args.tasks,
                                n_workers=args.workers)
        max_plen = args.prompt_len + args.max_new
        if args.scheduler == "tpfifo":
            eng = TPFIFOMCTSEngine(params, cfg, dcfg, n_slots=args.slots,
                                   max_prompt_len=max_plen, grain=args.grain,
                                   policy=args.policy,
                                   preempt_quanta=args.preempt_quanta,
                                   seed=args.seed, **obs)
        else:
            eng = MCTSSlotEngine(params, cfg, dcfg, n_slots=args.slots,
                                 max_prompt_len=max_plen, seed=args.seed,
                                 **obs)
    elif args.scheduler == "tpfifo":
        eng = TPFIFOEngine(params, cfg, n_slots=args.slots,
                           max_len=args.prompt_len + args.max_new + 8,
                           grain=args.grain, policy=args.policy,
                           preempt_quanta=args.preempt_quanta,
                           temperature=args.temperature, seed=args.seed,
                           **obs)
    else:
        eng = SlotEngine(params, cfg, n_slots=args.slots,
                         max_len=args.prompt_len + args.max_new + 8,
                         temperature=args.temperature, seed=args.seed, **obs)

    for rid in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(1, cfg.vocab, size=(plen,),
                                               dtype=np.int64).astype(np.int32),
                           max_new=args.max_new))
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in done)
    mode = ("GSCPM " if args.mcts else "") + args.scheduler
    print(f"[{mode}] served {len(done)} requests, {tok} tokens in {dt:.1f}s "
          f"({tok/dt:.1f} tok/s, {args.slots} slots)")
    st = eng.stats()
    line = (f"  queue wait p50/p95 {st.queue_wait_p50*1e3:.0f}/"
            f"{st.queue_wait_p95*1e3:.0f} ms, latency p50/p95 "
            f"{st.latency_p50*1e3:.0f}/{st.latency_p95*1e3:.0f} ms")
    if args.scheduler == "tpfifo":    # lockstep engines have no quanta
        line += f", {st.quanta} quanta, {st.n_preemptions} preemptions"
    print(line)
    finish_observers(args)


def serve_games(args) -> None:
    """Board-game search traffic through the TPFIFO quantum engine."""
    from repro_torch.serve.games import GameRequest, TPFIFOGameEngine

    games = (["hex", "gomoku"] if args.mcts_game == "mixed"
             else [args.mcts_game])
    injector = None
    if args.chaos_rate > 0:
        from repro_torch.serve.resilience import FaultInjector, FaultPlan
        injector = FaultInjector(FaultPlan.generate(
            seed=args.chaos_seed, n_ticks=4096,
            n_slots=args.slots * len(games), rate=args.chaos_rate))
    eng = TPFIFOGameEngine(n_slots=args.slots, grain=args.grain,
                           policy=args.policy,
                           preempt_quanta=args.preempt_quanta,
                           n_workers=args.workers,
                           metrics=args.device_metrics,
                           max_queue=args.max_queue,
                           quarantine_after=args.quarantine_after,
                           injector=injector,
                           tracer=args.tracer, registry=args.registry,
                           device=args.device)
    rng = np.random.default_rng(args.seed)
    shed = 0
    for rid in range(args.requests):
        # heterogeneous budgets around --playouts (the irregular workload)
        npo = max(1, int(args.playouts * rng.choice((0.5, 1.0, 2.0))))
        if not eng.submit(GameRequest(
                rid=rid, game=games[rid % len(games)],
                board_size=args.board_size, n_playouts=npo,
                n_tasks=args.tasks, seed=args.seed + rid,
                deadline_s=args.deadline)):
            shed += 1
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    playouts = sum(r.result["playouts"] for r in done)
    print(f"[game tpfifo] served {len(done)} searches, {playouts} playouts "
          f"in {dt:.1f}s ({playouts/dt:.0f} playouts/s, "
          f"{args.slots} slots per game class)")
    for r in done:
        res = r.result
        tag = " (deadline)" if res["deadline_expired"] else ""
        if res.get("retries"):
            tag += f" ({res['retries']} retries)"
        print(f"  req {r.rid}: {res['game']:>6} {res['board_size']}x"
              f"{res['board_size']} -> move {res['best_move']:>3} "
              f"value {res['root_value']:+.3f}  {res['playouts']} playouts, "
              f"{res['rounds']}/{res['rounds_total']} rounds{tag}")
    st = eng.stats()
    print(f"  queue wait p50/p95 {st.queue_wait_p50*1e3:.0f}/"
          f"{st.queue_wait_p95*1e3:.0f} ms, move latency p50/p95 "
          f"{st.latency_p50*1e3:.0f}/{st.latency_p95*1e3:.0f} ms, "
          f"{st.quanta} quanta, {st.n_preemptions} preemptions")
    if injector is not None or shed or st.n_retries or st.n_quarantined:
        fired = injector.summary() if injector is not None else None
        print(f"  resilience: {st.n_retries} retries, "
              f"{st.n_quarantined} quarantined slots, {st.n_shed} shed"
              + (f", faults fired {fired['fired_total']}"
                 f"/{fired['planned']} {fired['fired']}" if fired else ""))
    if args.device_metrics and done:
        dm = done[0].result["metrics"]
        print(f"  device metrics (req {done[0].rid}): "
              f"depth mean/max {dm['depth_mean']:.2f}/{dm['depth_max']}, "
              f"{dm['expansions']} expansions, "
              f"playout len mean {dm['playout_len_mean']:.1f}, "
              f"leaf-collision rate {dm['leaf_collision_rate']:.2f}")
    finish_observers(args)


if __name__ == "__main__":
    main()
