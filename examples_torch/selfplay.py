"""Self-play sessions: two whole games with cross-move tree reuse, on the
port.

The torch twin of ``examples/selfplay.py``: two ``GameSession`` tenants,
one playing 5x5 Hex and one 5x5 Gomoku, share one TPFIFO engine and play
their games to the end. Each session keeps its search tree on the device
between moves: after every ``play(move)`` the tree is re-rooted onto the
played child (``core.tree.reroot_tree``), so the next search starts from
the retained subtree and runs only the remainder of its evidence budget.
Per-move lines print the retained-visit fraction, the statistic
``benchmarks_torch/selfplay.py`` aggregates. ``--device cpu`` runs the
kernels' plain PyTorch versions.

    python examples_torch/selfplay.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.serve.games import GameSession, TPFIFOGameEngine  # noqa: E402

SIZE = 5
PLAYOUTS = 256
TASKS = 16
MAX_MOVES = 25
OUTCOME = {0: "draw", 1: "player 1 wins", 2: "player 2 wins"}


def play_out(eng, sess: GameSession, max_moves: int | None = None) -> None:
    print(f"[{sess.game} {SIZE}x{SIZE}] session {sess.name}")
    for _ in range(MAX_MOVES if max_moves is None else max_moves):
        req = sess.make_request(n_playouts=PLAYOUTS, n_tasks=TASKS)
        eng.submit(req)
        eng.run()
        res = req.result
        mv = res["best_move"]
        if mv < 0:
            break
        sess.play(mv)
        print(f"  mv{len(sess.moves):>3} p{3 - sess.to_move} -> {mv:>3}  "
              f"{res['playouts']:>4} fresh playouts, "
              f"reused {res['reused_visits']:>4} visits; after re-root "
              f"retained {sess.retained_fraction:.2f} of the tree's "
              f"evidence")
        if sess.over():
            break
    print(f"  {OUTCOME.get(sess.winner(), 'unfinished')} "
          f"after {len(sess.moves)} moves\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    dev = p.parse_args(argv).device
    # one engine, two game classes: each class owns its own slot pool and
    # both sessions ride it
    eng = TPFIFOGameEngine(n_slots=2, grain=4, n_workers=8, tree_cap=2048,
                           device=dev)
    sessions = [GameSession(eng, "hex", SIZE, base_seed=0),
                GameSession(eng, "gomoku", SIZE, base_seed=1)]
    for sess in sessions:
        play_out(eng, sess)
    return sessions


if __name__ == "__main__":
    main()
