"""Stateful game sessions, self-play and the serving launchers of the port,
against the JAX package's (DESIGN.md §16).

The scenarios are the session tests of ``tests/test_reroot.py`` at 5x5, 4
workers and ``tree_cap=512``: a warm session's served answer equals its
direct reference and the JAX engine's, custody and legality guards, the
cold ablation, a whole game with no kernel build; then
``repro_torch.launch.selfplay.play_game`` against
``repro.launch.selfplay.play_game`` move for move, and both launchers'
printed lines against the JAX launchers', times aside.

The port's trees are updated in place by the search: the direct warm
reference runs on a CLONE of the re-rooted tree, and reads that tree's
``n_nodes`` and ``visits[0]`` BEFORE the warm search (read afterwards
they would be the values after it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import re
import sys

import numpy as np
import pytest
import torch
from torch_parity_util import (RESULT_FIELDS, WARM_FIELDS, make_engine,
                               result_differences, serving_packages)

from repro.launch import selfplay as jselfplay
from repro.launch import serve as jserve
from repro.serve import games as jgames
from repro_torch import rng
from repro_torch.core.gscpm import gscpm_search
from repro_torch.core.tree import (Tree, check_reroot_retention, reroot_tree,
                                   root_summary)
from repro_torch.launch import selfplay as tselfplay
from repro_torch.launch import serve as tserve
from repro_torch.obsv.trace import kernel_builds
from repro_torch.serve import games as tgames

torch.set_num_threads(1)

SIZE = 5
CAP = 512
PKGS = ("jax", "torch")


def engine(pkg, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("grain", 2)
    kw.setdefault("n_workers", 4)
    kw.setdefault("tree_cap", CAP)
    return make_engine(pkg, **kw)


def session(pkg, eng, game="hex", **kw):
    games, _ = serving_packages()[pkg]
    return games.GameSession(eng, game, SIZE, **kw)


def serve(eng, req):
    eng.submit(req)
    eng.run()
    return req.result


# ------------------------------------------------------------ warm sessions ----
@pytest.fixture(scope="module")
def two_moves():
    """Move 0 cold, move 1 warm, through a session of each package."""
    out = {}
    for pkg in PKGS:
        eng = engine(pkg)
        sess = session(pkg, eng, base_seed=11)
        r0 = serve(eng, sess.make_request(n_playouts=64, n_tasks=8))
        sess.play(r0["best_move"])
        retained = sess.retained_visits
        r1 = serve(eng, sess.make_request(n_playouts=64, n_tasks=8))
        out[pkg] = (eng, sess, r0, r1, retained)
    return out


@pytest.mark.parametrize("move", [0, 1], ids=["cold", "warm"])
def test_session_answers_equal_jax_engine(two_moves, move):
    j, t = two_moves["jax"], two_moves["torch"]
    ra, rb = j[2 + move], t[2 + move]
    fields = RESULT_FIELDS + tuple(k for k in WARM_FIELDS if k in ra)
    assert set(k for k in WARM_FIELDS if k in rb) == set(
        k for k in WARM_FIELDS if k in ra)
    assert result_differences(ra, rb, fields) == []
    assert j[4] == t[4]          # retained visits after the re-root


def test_session_served_warm_matches_direct_reference(two_moves):
    """The whole serving loop (checkout, warm budget, quantum-served
    search, re-root) equals the direct two-move reference: cold search,
    ``reroot_tree``, ``warm_budget``, warm ``gscpm_search`` on a clone,
    with the warm tree's fields read before the warm search."""
    eng, _, r0, r1, _ = two_moves["torch"]
    mv = r0["best_move"]
    c = eng.request_cfg(tgames.GameRequest(rid="ref", game="hex",
                                           board_size=SIZE, n_playouts=64,
                                           n_tasks=8, seed=11))
    board0 = c.game_obj.init_board("cpu")
    t0, _ = gscpm_search(board0, 1, c, rng.key(11, "cpu"), device="cpu")
    warm = reroot_tree(t0, mv)
    check_reroot_retention(t0, warm, mv)
    reused = float(warm.visits[0])          # read BEFORE the warm search
    reused_nodes = int(warm.n_nodes) - 1
    eff_po, eff_tasks = tgames.warm_budget(64, 8, c.n_workers, reused)
    c1 = dataclasses.replace(c, n_playouts=eff_po, n_tasks=eff_tasks)
    board1 = c.game_obj.place(board0, mv, 1)
    t1, s1 = gscpm_search(board1, 2, c1, rng.key(12, "cpu"),
                          tree=Tree(*(x.clone() for x in warm)),
                          device="cpu")
    ref = root_summary(t1, c.game_obj.n_actions)
    assert result_differences(r1, ref, ("root_visits", "root_wins",
                                        "best_move", "root_value",
                                        "tree_nodes")) == []
    assert r1["reused_visits"] == int(reused) > 0
    assert r1["reused_nodes"] == reused_nodes > 0
    assert r1["playouts"] == s1["playouts"] < 64
    # the clone kept the reference's input intact
    assert int(warm.n_nodes) - 1 == reused_nodes


def test_session_hands_the_searched_tree_back(two_moves):
    eng, sess, _, r1, _ = two_moves["torch"]
    assert sess.tree is not None and sess.last_result is r1
    assert int(sess.tree.n_nodes) == r1["tree_nodes"]
    assert not eng.has_work()


def test_session_custody_and_legality_guards():
    eng = engine("torch")
    sess = session("torch", eng)
    req = sess.make_request(n_playouts=16, n_tasks=2)
    with pytest.raises(RuntimeError, match="already in flight"):
        sess.make_request()
    with pytest.raises(RuntimeError, match="in flight"):
        sess.play(0)
    serve(eng, req)
    mv = req.result["best_move"]
    sess.play(mv)
    with pytest.raises(ValueError, match="illegal move"):
        sess.play(mv)
    assert sess.retained_visits > 0
    assert 0.0 < sess.retained_fraction <= 1.0


def test_request_board_is_a_copy():
    """The request carries a host copy of the session's board; changing it
    changes neither the session nor the served search."""
    eng = engine("torch")
    sess = session("torch", eng)
    req = sess.make_request(n_playouts=16, n_tasks=2)
    assert isinstance(req.board, np.ndarray) and req.board.dtype == np.int8
    req.board[0] = 2
    assert int(sess.board[0]) == 0


@pytest.fixture(scope="module")
def cold_and_warm():
    out = {}
    for pkg in PKGS:
        eng = engine(pkg)
        arms = {}
        for arm, reuse in (("warm", True), ("cold", False)):
            sess = session(pkg, eng, base_seed=3, reuse_tree=reuse)
            r0 = serve(eng, sess.make_request(n_playouts=32, n_tasks=4))
            sess.play(r0["best_move"])
            kept = sess.tree is not None
            r1 = serve(eng, sess.make_request(n_playouts=32, n_tasks=4))
            arms[arm] = (sess, kept, r0, r1)
        out[pkg] = arms
    return out


@pytest.mark.parametrize("arm", ["warm", "cold"])
def test_cold_ablation_equal_jax_engine(cold_and_warm, arm):
    j, t = cold_and_warm["jax"][arm], cold_and_warm["torch"][arm]
    assert j[1] == t[1]
    for ra, rb in ((j[2], t[2]), (j[3], t[3])):
        fields = RESULT_FIELDS + tuple(k for k in WARM_FIELDS if k in ra)
        assert result_differences(ra, rb, fields) == []


def test_cold_session_ablation_never_reuses(cold_and_warm):
    arms = cold_and_warm["torch"]
    for arm, want in (("warm", True), ("cold", False)):
        _, kept, _, r1 = arms[arm]
        assert kept == want
        assert (r1["reused_visits"] > 0) == want
        if not want:
            assert r1["reused_nodes"] == 0
    assert arms["cold"][0].last_result["playouts"] == 32
    assert arms["warm"][0].last_result["playouts"] < 32


def test_whole_game_builds_no_kernel_and_equals_jax_engine():
    """A whole session game (warm budgets, re-roots, every position) builds
    nothing after the first request, and plays the JAX engine's moves."""
    moves = {}
    for pkg in PKGS:
        eng = engine(pkg)
        serve(eng, serving_packages()[pkg][0].GameRequest(
            rid="warm", game="hex", board_size=SIZE, n_playouts=8,
            n_tasks=2, seed=0))
        builds = kernel_builds()
        sess = session(pkg, eng, base_seed=1)
        log = []
        for _ in range(6):
            res = serve(eng, sess.make_request(n_playouts=48, n_tasks=6))
            log.append((res["best_move"], res["reused_visits"],
                        res["playouts"], res["tree_nodes"]))
            if res["best_move"] < 0:
                break
            sess.play(res["best_move"])
            if sess.over():
                break
        assert kernel_builds() == builds
        moves[pkg] = (log, sess.winner())
    assert moves["torch"] == moves["jax"]
    log = moves["torch"][0]
    assert len(log) >= 2 and max(r for _, r, _, _ in log) > 0


@pytest.mark.parametrize("args", [(512, 16, 8, 100.0), (512, 16, 8, 512.0),
                                  (512, 16, 8, 10_000.0), (512, 16, 8, 0.0),
                                  (64, 8, 4, 6.0), (48, 6, 4, 47.0)])
def test_warm_budget_equals_jax_package(args):
    assert tgames.warm_budget(*args) == jgames.warm_budget(*args)


def test_session_runs_on_the_gpu_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    eng = tgames.TPFIFOGameEngine(n_workers=4, tree_cap=64)
    assert eng.device == torch.device("cuda")
    with pytest.raises((AssertionError, RuntimeError)):
        tgames.GameSession(eng, "hex", SIZE)
    cpu = tgames.TPFIFOGameEngine(n_workers=4, tree_cap=64, device="cpu")
    sess = tgames.GameSession(cpu, "hex", SIZE)
    assert sess.device == cpu.device == torch.device("cpu")
    assert sess.board.device == cpu.device


# ----------------------------------------------------------------- selfplay ----
@pytest.mark.parametrize("game,reuse,po", [
    ("hex", True, (48, 48)), ("hex", False, (48, 48)),
    ("gomoku", True, (32, 64))], ids=["hex-warm", "hex-cold", "gomoku-asym"])
def test_play_game_equals_jax_package(game, reuse, po):
    summ = {}
    for pkg, mod in (("jax", jselfplay), ("torch", tselfplay)):
        eng = engine(pkg, n_slots=2, grain=4)
        summ[pkg] = mod.play_game(eng, game, SIZE, playouts=po, tasks=6,
                                  seed=2, reuse=reuse, max_moves=4,
                                  quiet=True)
    for k in ("winner", "n_moves", "moves", "retained_fractions",
              "mean_retained_fraction"):
        assert summ["torch"][k] == summ["jax"][k], k
    assert summ["torch"]["n_moves"] == 4


# ---------------------------------------------------------------- launchers ----
_TIMES = [(re.compile(r"in [0-9.]+s \([0-9]+ playouts/s"), "in T (R playouts/s"),
          (re.compile(r"p50/p95 [0-9]+/[0-9]+ ms"), "p50/p95 T ms"),
          (re.compile(r" +[0-9]+ ms$", re.M), " T ms"),
          (re.compile(r"moves in [0-9.]+s"), "moves in T")]


def _untimed(text: str) -> str:
    for pat, sub in _TIMES:
        text = pat.sub(sub, text)
    return text


def _run_jax_main(main, argv: list[str]) -> str:
    buf, saved = io.StringIO(), sys.argv
    sys.argv = ["prog", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        sys.argv = saved
    return buf.getvalue()


def _run_port_main(main, argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([*argv, "--device", "cpu"])
    return buf.getvalue()


SERVE_BASE = ["--mcts-game", "mixed", "--board-size", str(SIZE),
              "--requests", "4", "--slots", "1", "--grain", "2",
              "--preempt-quanta", "1", "--playouts", "32", "--tasks", "8"]
SERVE_CASES = {
    "mixed": [],
    "hex-metrics": ["--mcts-game", "hex", "--device-metrics"],
    "chaos": ["--chaos-rate", "0.2", "--chaos-seed", "3",
              "--quarantine-after", "3"],
    "deadline-zero": ["--mcts-game", "gomoku", "--deadline", "0",
                      "--policy", "rebalance"],
    "shed": ["--max-queue", "1"],
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_launcher_prints_the_jax_launchers_lines(case):
    argv = SERVE_BASE + SERVE_CASES[case]
    want = _run_jax_main(jserve.main, ["--scheduler", "tpfifo", *argv])
    got = _run_port_main(tserve.main, argv)
    assert _untimed(got) == _untimed(want)
    assert got.startswith("[game tpfifo] served ")


def test_serve_launcher_writes_trace_and_metrics(tmp_path):
    from repro_torch.obsv import validate_trace
    trace, snap = tmp_path / "t.json", tmp_path / "m.json"
    out = _run_port_main(tserve.main, SERVE_BASE + [
        "--trace", str(trace), "--metrics-out", str(snap)])
    assert validate_trace(str(trace)) > 0 and snap.exists()
    assert "trace:" in out and "metrics snapshot" in out


def test_serve_launcher_game_mode_refuses_lockstep():
    with pytest.raises(SystemExit):
        tserve.main(SERVE_BASE + ["--scheduler", "lockstep",
                                  "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--cold"], ["--game", "gomoku",
                                                "--playouts2", "48"]],
                         ids=["hex-cold", "gomoku-asym"])
def test_selfplay_launcher_prints_the_jax_launchers_lines(flags):
    argv = ["--size", str(SIZE), "--playouts", "32", "--tasks", "4",
            "--workers", "4", "--grain", "2", "--max-moves", "3",
            "--tree-cap", str(CAP), *flags]
    want = _run_jax_main(jselfplay.main, argv)
    got = _run_port_main(tselfplay.main, argv)
    assert _untimed(got) == _untimed(want)
    assert got.count("  mv") == 3
