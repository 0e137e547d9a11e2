"""Cross-move tree reuse: warm vs cold move latency over a self-play game,
on the port.

The torch twin of ``benchmarks/selfplay.py``: a ``GameSession`` plays a
whole game through the TPFIFO engine, re-rooting its tree after every move
so each search starts from the retained subtree and only runs the remainder
of its evidence budget (``serve.games.warm_budget``). At every position a
paired COLD request (same position, same budget, fresh tree) is served
through the same engine; the trajectory advances with the warm arm's move.

The same ``play_paired_game``, result keys and assertion as the JAX twin:
the whole game (re-roots included) builds nothing after the per-class
warm-up (``obsv.trace.kernel_builds``, reported under ``recompiles``).
``run()``'s defaults are the JAX twin's; ``CARD`` is the GPU's form (11x11,
256 lanes, 32,768 playouts in 4,096 tasks: the JAX twin's grain m = 8, which
its comment explains must stay fine for retained visits to become latency).

    PYTHONPATH=src python -m benchmarks_torch.selfplay [--smoke|--full] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.obsv.trace import kernel_builds
from repro_torch.serve.games import GameRequest, GameSession, TPFIFOGameEngine

from benchmarks_torch.common import device_stamp, resolve_device, save_result
from benchmarks_torch.serve_games import differs_from_jax

GAMES = ("hex", "gomoku")

JAX_DEFAULTS = dict(n_playouts=1024, n_tasks=128, board_size=7,
                    max_moves=12, n_workers=8, grain=4, tree_cap=None,
                    seed=0)
CARD = dict(n_playouts=32 * 1024, n_tasks=4096, board_size=11,
            n_workers=256)


def _serve_one(eng, req) -> float:
    """Submit one request, run it to completion, return wall seconds."""
    t0 = time.perf_counter()
    eng.submit(req)
    eng.run()
    return time.perf_counter() - t0


def play_paired_game(eng, game: str, board_size: int, *, n_playouts: int,
                     n_tasks: int, max_moves: int, seed: int,
                     cp: float = 0.25) -> dict:
    """One self-play trajectory with a paired cold search at every position.

    The session (one tenant playing both sides: exactly one re-root per
    move) produces the warm measurements and the moves; each cold
    measurement is a stateless request for the same position and the same
    total budget, served by the same engine. ``cp`` is low (0.25), as in
    the JAX twin: retention, and so the warm arm's advantage, depends on how
    concentrated the root visits are.
    """
    sess = GameSession(eng, game, board_size, base_seed=seed,
                       name=f"bench-{game}")
    warm_s, cold_s, retained = [], [], []
    for mvno in range(max_moves):
        # cold arm first (its tree is dropped at retirement; the order
        # cannot leak state into the warm arm)
        cold = GameRequest(
            rid=f"cold-{game}#{mvno}", game=game, board_size=board_size,
            to_move=sess.to_move, n_playouts=n_playouts, n_tasks=n_tasks,
            cp=cp, seed=seed + mvno, board=sess.board.cpu().numpy().copy())
        cold_s.append(_serve_one(eng, cold))

        req = sess.make_request(n_playouts=n_playouts, n_tasks=n_tasks,
                                cp=cp)
        warm_s.append(_serve_one(eng, req))
        res = req.result
        retained.append(res["reused_visits"] / n_playouts)

        mv = res["best_move"]
        if mv < 0:
            break
        sess.play(mv)
        if sess.winner() >= 0:
            break
    return {
        "game": game,
        "n_moves": len(warm_s),
        "moves": list(sess.moves),
        "warm_latency_s": warm_s,
        "cold_latency_s": cold_s,
        "retained_fractions": retained,
        "warm_p50_s": float(np.percentile(warm_s, 50)),
        "warm_p95_s": float(np.percentile(warm_s, 95)),
        "cold_p50_s": float(np.percentile(cold_s, 50)),
        "cold_p95_s": float(np.percentile(cold_s, 95)),
        "mean_retained_fraction": float(np.mean(retained)),
        "p50_speedup": float(np.percentile(cold_s, 50)
                             / max(np.percentile(warm_s, 50), 1e-9)),
    }


def run(n_playouts: int = 1024, n_tasks: int = 128, board_size: int = 7,
        max_moves: int = 12, n_workers: int = 8, grain: int = 4,
        tree_cap: int | None = None, seed: int = 0,
        smoke: bool = False, device=None) -> dict:
    if smoke:
        n_playouts, n_tasks, board_size, max_moves = 64, 8, 5, 3
    device = resolve_device(device)
    cap = tree_cap or max(2048, 4 * n_playouts)

    eng = TPFIFOGameEngine(n_slots=2, grain=grain, n_workers=n_workers,
                           tree_cap=cap, device=device)

    # builds off the clock: one tiny search per game class runs every op
    # each class ever runs; the whole benchmark (warm and cold arms,
    # re-roots, every budget) must then build nothing
    for g in GAMES:
        _serve_one(eng, GameRequest(rid=f"warm-{g}", game=g,
                                    board_size=board_size, n_playouts=8,
                                    n_tasks=2, seed=0))
    builds_before = kernel_builds()

    games = {}
    for g in GAMES:
        games[g] = play_paired_game(eng, g, board_size,
                                    n_playouts=n_playouts, n_tasks=n_tasks,
                                    max_moves=max_moves, seed=seed)
    recompiles = kernel_builds() - builds_before
    assert recompiles == 0, \
        f"self-play (with re-rooting) built the kernel library {recompiles} " \
        f"times"

    best = max(games.values(), key=lambda s: s["p50_speedup"])
    knobs = dict(n_playouts=n_playouts, n_tasks=n_tasks,
                 board_size=board_size, max_moves=max_moves,
                 n_workers=n_workers, grain=grain, tree_cap=tree_cap,
                 seed=seed)
    return {
        "config": {**knobs, "tree_cap": cap, "cp": 0.25, "smoke": smoke,
                   "differs_from_jax": differs_from_jax(JAX_DEFAULTS,
                                                        **knobs)},
        "device": device_stamp(device),
        "games": games,
        "selfplay": {
            "board": f"{board_size}x{board_size}",
            "n_playouts": n_playouts,
            "warm_move_p50_s": best["warm_p50_s"],
            "warm_move_p95_s": best["warm_p95_s"],
            "cold_move_p50_s": best["cold_p50_s"],
            "cold_move_p95_s": best["cold_p95_s"],
            "mean_retained_fraction": float(np.mean(
                [s["mean_retained_fraction"] for s in games.values()])),
            "p50_speedup_warm_vs_cold": best["p50_speedup"],
            "best_game": best["game"],
            "recompiles": recompiles,
            "per_game": {g: {
                "warm_p50_s": s["warm_p50_s"],
                "cold_p50_s": s["cold_p50_s"],
                "p50_speedup": s["p50_speedup"],
                "mean_retained_fraction": s["mean_retained_fraction"],
            } for g, s in games.items()},
        },
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true",
                   help="tiny game (a check that it runs)")
    p.add_argument("--full", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda")
    args = p.parse_args(argv)

    out = (run(smoke=True, device=args.device) if args.smoke
           else run(**CARD, max_moves=20 if args.full else 12,
                    device=args.device))
    for g, s in out["games"].items():
        print(f"{g:>8}: warm p50/p95 {s['warm_p50_s']*1e3:6.0f}/"
              f"{s['warm_p95_s']*1e3:6.0f} ms   cold p50/p95 "
              f"{s['cold_p50_s']*1e3:6.0f}/{s['cold_p95_s']*1e3:6.0f} ms   "
              f"retained {s['mean_retained_fraction']:.2f}   "
              f"p50 speedup {s['p50_speedup']:.2f}x")
    s = out["selfplay"]
    print(f"best ({s['best_game']}): warm beats cold "
          f"{s['p50_speedup_warm_vs_cold']:.2f}x at p50; "
          f"recompiles during self-play: {s['recompiles']}")
    print("->", save_result("selfplay", out))
    return out


if __name__ == "__main__":
    main()
