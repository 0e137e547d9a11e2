"""Self-play launcher: whole games through stateful sessions (port of
``repro.launch.selfplay``; DESIGN.md §16).

``python -m repro_torch.launch.selfplay --game hex --size 7 --playouts 512``
plays one complete game on the GPU (``--device cpu``: the same game with
the kernels' plain PyTorch versions): each player owns a ``GameSession``
on a shared ``TPFIFOGameEngine``, every move is a ``GameRequest`` served
through the per-game-class quantum pools, and after each move BOTH
sessions re-root their device-resident trees onto the played child
(``core.tree.reroot_tree``) so the next search starts warm. Per-move lines report the retained-visit
fraction — the amortization the cross-move reuse machinery buys.

Flags of note:

- ``--cold``: the ablation arm — sessions keep the full lifecycle but drop
  their trees at every move, so every search starts from scratch;
- ``--playouts2 N``: engine-vs-engine with asymmetric budgets (player 1
  searches ``--playouts``, player 2 searches ``N``);
- ``--game2``: unused boards are not a thing — but two GAMES can run
  back-to-back (``--game hex --game2 gomoku`` plays one game of each);
- ``--trace OUT.json``: the serving trace (admissions, quanta, re-roots
  ride as ordinary requests) in Chrome/Perfetto format.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core import game as game_mod


def play_game(eng, game: str, size: int, *, playouts: tuple[int, int],
              tasks: int, cp: float = 1.0, seed: int = 0,
              reuse: bool = True, max_moves: int | None = None,
              deadline_s: float | None = None, quiet: bool = False) -> dict:
    """One full game; returns a summary dict (winner, moves, retention).

    Two sessions — one per player — share the engine (and therefore the
    game class's slot pool). Each session observes
    every move via ``play``: its own choices and the opponent's, so both
    trees stay rooted at the CURRENT position and the retained subtree is
    whatever each player's last search knew about the line actually played.
    """
    from repro_torch.serve.games import GameSession

    sessions = {
        1: GameSession(eng, game, size, reuse_tree=reuse, base_seed=seed,
                       name=f"{game}-p1"),
        2: GameSession(eng, game, size, reuse_tree=reuse,
                       base_seed=seed + 1_000_003, name=f"{game}-p2"),
    }
    limit = max_moves or sessions[1].game_obj.max_moves
    moves, fractions, latencies = [], [], []
    winner = -1
    t0 = time.perf_counter()
    while len(moves) < limit:
        side = sessions[1].to_move     # both sessions track the same game
        sess = sessions[side]
        req = sess.make_request(n_playouts=playouts[side - 1],
                                n_tasks=tasks, cp=cp, deadline_s=deadline_s)
        t_mv = time.perf_counter()
        eng.submit(req)
        eng.run()
        dt_mv = time.perf_counter() - t_mv
        res = req.result
        mv = res["best_move"]
        if mv < 0:      # no legal move was ever expanded: the game is over
            break
        for s in sessions.values():
            s.play(mv)
        moves.append(int(mv))
        fractions.append(sess.retained_fraction)
        latencies.append(dt_mv)
        if not quiet:
            print(f"  mv{len(moves):>3} p{side} -> {mv:>3}  "
                  f"value {res['root_value']:+.3f}  "
                  f"{res['playouts']:>5} playouts "
                  f"(reused {res.get('reused_visits', 0):>5} visits, "
                  f"retained {sess.retained_fraction:.2f})  "
                  f"{dt_mv * 1e3:6.0f} ms")
        winner = sessions[1].winner()
        if winner >= 0:
            break
    dt = time.perf_counter() - t0
    return {
        "game": game, "size": size, "winner": int(winner),
        "n_moves": len(moves), "moves": moves, "time_s": dt,
        "move_latencies_s": latencies,
        "retained_fractions": fractions,
        "mean_retained_fraction": (sum(fractions) / len(fractions)
                                   if fractions else 0.0),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--game", default="hex",
                   choices=list(game_mod.available_games()))
    p.add_argument("--game2", default=None,
                   choices=list(game_mod.available_games()),
                   help="also play one game of this (after --game)")
    p.add_argument("--size", type=int, default=7, help="board side length")
    p.add_argument("--playouts", type=int, default=512,
                   help="player 1's total root evidence per move")
    p.add_argument("--playouts2", type=int, default=None,
                   help="player 2's budget (default: same as player 1) — "
                        "engine-vs-engine with asymmetric strength")
    p.add_argument("--tasks", type=int, default=16)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--grain", type=int, default=4,
                   help="quantum size in schedule rounds")
    p.add_argument("--tree-cap", type=int, default=None,
                   help="node capacity per tree (default: 4x the larger "
                        "budget, min 4096)")
    p.add_argument("--cp", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-moves", type=int, default=None)
    p.add_argument("--deadline", type=float, default=None,
                   help="per-move time budget in seconds")
    p.add_argument("--cold", action="store_true",
                   help="ablation: drop the tree after every move")
    p.add_argument("--metrics", action="store_true",
                   help="device-plane SearchMetrics per served move")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="Chrome/Perfetto trace of the whole self-play run")
    p.add_argument("--device", default="cuda",
                   help="torch device of the searches (default: cuda, which "
                        "raises without a GPU)")
    args = p.parse_args(argv)

    tracer = None
    if args.trace:
        from repro_torch.obsv import TraceRecorder
        tracer = TraceRecorder(process_name="repro-selfplay")

    from repro_torch.serve.games import TPFIFOGameEngine

    po2 = args.playouts2 if args.playouts2 is not None else args.playouts
    cap = args.tree_cap or max(4096, 4 * max(args.playouts, po2))
    eng = TPFIFOGameEngine(n_slots=2, grain=args.grain,
                           n_workers=args.workers, tree_cap=cap,
                           metrics=args.metrics, tracer=tracer,
                           device=args.device)

    games = [args.game] + ([args.game2] if args.game2 else [])
    for g in games:
        mode = "cold" if args.cold else "warm"
        vs = (f"{args.playouts} vs {po2}" if po2 != args.playouts
              else f"{args.playouts}")
        print(f"[selfplay {g} {args.size}x{args.size}] {mode}, "
              f"{vs} playouts/move")
        summ = play_game(eng, g, args.size,
                         playouts=(args.playouts, po2), tasks=args.tasks,
                         cp=args.cp, seed=args.seed, reuse=not args.cold,
                         max_moves=args.max_moves,
                         deadline_s=args.deadline)
        who = {0: "draw", 1: "player 1", 2: "player 2"}.get(
            summ["winner"], "unfinished")
        print(f"  {who} after {summ['n_moves']} moves in "
              f"{summ['time_s']:.1f}s (mean retained fraction "
              f"{summ['mean_retained_fraction']:.2f})")

    if tracer is not None:
        from repro_torch.obsv import validate_trace
        path = tracer.save(args.trace)
        print(f"  trace: {validate_trace(path)} events -> {path}")


if __name__ == "__main__":
    main()
