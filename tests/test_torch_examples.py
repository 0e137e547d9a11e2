"""The port's examples (``examples_torch/``) run on the CPU at a small size
and print the JAX examples' lines; without ``--device cpu`` they, like the
serving benchmarks, ask for the GPU and raise on a machine without one.

Where an example's output has no clock in it, its lines are held against
the JAX example's, run at the same size (``selfplay``: every line;
``chaos_serving``: every line but the two that name the build ledger, a
jit cache there and the kernel library here).
"""

from __future__ import annotations

import importlib.util
import pathlib
import re
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)

NO_GPU = (AssertionError, RuntimeError)   # what torch raises without a card


def load(package: str, name: str):
    path = ROOT / package / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{package}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL = {
    "quickstart": dict(BOARD_SIZE=5, N_PLAYOUTS=64, N_WORKERS=4,
                       TASK_SWEEP=(4, 8, 16)),
    "root_parallel_demo": dict(BOARD_SIZE=5, N_PLAYOUTS=32, N_WORKERS=2,
                               N_TREES=3, N_TASKS=4, TREE_CAP=256),
    "serve_games": dict(BOARD_SIZE=5, N_WORKERS=4, REQUESTS=(
        ("hex-big", "hex", 64, 8, 0, None),
        ("gomoku-big", "gomoku", 64, 8, 1, None),
        ("hex-quick", "hex", 16, 4, 2, None),
        ("gomoku-dl", "gomoku", 128, 8, 3, 0.0))),
    "selfplay": dict(SIZE=4, PLAYOUTS=16, TASKS=4, MAX_MOVES=3),
    "chaos_serving": dict(N_REQUESTS=4, N_PLAYOUTS=32, N_TASKS=8),
    "trace_serving": dict(BOARD_SIZE=5, N_WORKERS=4, TENANTS=(
        ("hex-big", "hex", 64, 8, 0), ("gomoku-big", "gomoku", 64, 8, 1),
        ("hex-quick", "hex", 16, 4, 2)), TABLE_TASKS=(4, 16)),
    "serve_mcts": dict(SWEEP_TASKS=(4,)),
}
# what each example prints: (line pattern, how many such lines)
LINES = {
    "quickstart": [(r"^Hex 5x5, 64 playouts, 4 lanes$", 1),
                   (r"^sequential: +\d+ playouts/s  best move \d+  root "
                    r"value [\d.]+$", 1),
                   (r"^GSCPM nTasks= +\d+ \(.*\): +\d+ playouts/s  speedup "
                    r"+[\d.]+x  best move \d+$", 3)],
    "root_parallel_demo": [(r"^single tree +: +\d+ playouts/s  best move "
                            r"\d+$", 1),
                           (r"^E=3 \(.*\): +\d+ playouts/s  aggregate", 2),
                           (r"^    member votes \[\d+, \d+, \d+\]$", 2),
                           (r"^    visit-sum merge -> \d+   majority vote "
                            r"-> \d+$", 2)],
    "serve_games": [(r"^ *[a-z-]+: +(hex|gomoku) -> move +-?\d+ value "
                     r"[+-][\d.]+ +\d+ playouts \(\d+/\d+ rounds, \d+ "
                     r"preemptions\)", 4),
                    (r"<- deadline, partial stats$", 1),
                    (r"^4 searches, \d+ quanta, \d+ preemptions; move "
                     r"latency p50/p95", 1)],
    "selfplay": [(r"^\[(hex|gomoku) 4x4\] session", 2),
                 (r"^  mv +\d+ p[12] -> +\d+ +\d+ fresh playouts, reused "
                  r"+\d+ visits; after re-root retained [\d.]+ of the "
                  r"tree's evidence$", 6)],
    "chaos_serving": [(r"^clean serve: 4 answered, 0 builds", 1),
                      (r"^chaos serve: \d+ faults fired", 1),
                      (r"bit-identical to clean: True$", 4),
                      (r"^kernel library builds across chaos: 0 \(must be "
                       r"0\)$", 1)],
    "trace_serving": [(r"^ *[a-z-]+: +(hex|gomoku) -> move .* depth mean "
                       r"[\d.]+, \d+ expansions, leaf-collision rate", 3),
                      (r"^trace: \d+ events -> ", 1),
                      (r"^compile counts: \{'run_chunk': 0\}$", 1),
                      (r"^measured dispatch profile \(\d+ spans", 1),
                      (r"^ tasks  grain  par\(analytic\)", 1)],
    "serve_mcts": [(r"^slot engine: 8 requests, 96 tokens", 1),
                   (r"^GSCPM nTasks=  4 grain m= 16: 64 playouts -> tree", 1),
                   (r"^MCTS slot engine: 5 requests, 20 searched tokens", 1),
                   (r"^TPFIFO engine: 8 requests, \d+ tokens in \d+ quanta "
                    r"of m=8", 1)],
}


@pytest.mark.parametrize("name", list(SMALL))
def test_example_runs_on_the_cpu(name, monkeypatch, capsys, tmp_path):
    mod = load("examples_torch", name)
    for k, v in SMALL[name].items():
        assert hasattr(mod, k), k
        monkeypatch.setattr(mod, k, v)
    argv = ["--device", "cpu"]
    if name == "trace_serving":
        argv += ["--trace", str(tmp_path / "trace.json")]
    mod.main(argv)
    lines = capsys.readouterr().out.splitlines()
    for pattern, n in LINES[name]:
        got = [ln for ln in lines if re.search(pattern, ln)]
        assert len(got) == n, (pattern, lines)
    if name == "trace_serving":
        from repro_torch.obsv import validate_trace
        assert validate_trace(str(tmp_path / "trace.json")) > 0


@pytest.mark.parametrize("name", list(SMALL))
def test_example_means_the_gpu_and_raises_without_one(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it has none")
    mod = load("examples_torch", name)
    for k, v in SMALL[name].items():
        setattr(mod, k, v)
    argv = ["--trace", str(tmp_path / "t.json")] if name == "trace_serving" \
        else []
    with pytest.raises(NO_GPU):
        mod.main(argv)


@pytest.mark.parametrize("bench", ["serve_games", "serve_chaos", "selfplay",
                                   "kernels_micro"])
def test_serving_benchmark_means_the_gpu_and_raises_without_one(bench):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it has none")
    mod = importlib.import_module(f"benchmarks_torch.{bench}")
    kw = {} if bench == "kernels_micro" else dict(smoke=True)
    with pytest.raises(NO_GPU):
        mod.run(**kw)


def printed(mod, argv, capsys) -> list[str]:
    mod.main(argv)
    return capsys.readouterr().out.splitlines()


def test_selfplay_lines_equal_jax_example(monkeypatch, capsys):
    """Both examples at 5x5 with 16 playouts in 16 tasks a move: the same
    games move by move (moves, fresh playouts, reused visits, retention,
    outcome)."""
    jmod, tmod = load("examples", "selfplay"), load("examples_torch",
                                                    "selfplay")
    monkeypatch.setattr(jmod, "PLAYOUTS", 16)
    monkeypatch.setattr(tmod, "PLAYOUTS", 16)
    assert tmod.TASKS == 16 and tmod.SIZE == jmod.SIZE
    jmod.main()
    want = capsys.readouterr().out.splitlines()
    got = printed(tmod, ["--device", "cpu"], capsys)
    assert got == want and len(got) > 10


def test_chaos_serving_lines_equal_jax_example(capsys):
    """At the JAX example's own size: the same faults fired, retries,
    quarantines and answers, every one bit-identical to the clean run."""
    jmod, tmod = load("examples", "chaos_serving"), load("examples_torch",
                                                         "chaos_serving")
    jmod.main()
    want = capsys.readouterr().out.splitlines()
    got = printed(tmod, ["--device", "cpu"], capsys)
    assert len(got) == len(want) == 9
    assert got[1:-1] == want[1:-1]
    assert got[0].startswith("clean serve: 6 answered")
