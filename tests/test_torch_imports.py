"""The port stands alone: it imports neither jax nor the JAX package (and
its benchmarks not the JAX package's benchmarks), it runs on the GPU unless
told otherwise, and it refuses by name what it has not ported yet."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import rng
from repro_torch.core import gscpm as tg
from repro_torch.core import mcts as tmcts
from repro_torch.core import root_parallel as trp
from repro_torch.core import tree as tt
from repro_torch.launch import search as tsearch
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models.common import ModelConfig
from repro_torch.serve import engine as tengine
from repro_torch.serve import mcts_decode as tmd
from repro_torch.serve import tpfifo as ttpfifo

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_FILES = sorted((ROOT / "benchmarks_torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + BENCH_FILES
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}
# the port's benchmarks are the JAX package's benchmarks' twins, never
# their callers
FORBIDDEN_IN_BENCH = FORBIDDEN | {"benchmarks"}


def imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_port_files_are_found():
    names = {p.name for p in PORT_FILES}
    assert {"rng.py", "gscpm.py", "hex.py", "ops.py", "_build.py",
            "chip_smoke.py", "convert.py", "search.py", "mcts_decode.py",
            "attention.py", "transformer.py", "api.py", "layers.py",
            "common.py", "flash_attention.py", "rmsnorm.py", "engine.py",
            "tpfifo.py", "serve.py", "gomoku.py", "root_parallel.py",
            "cilkview.py", "hex_paper.py", "search_metrics.py", "trace.py",
            "metrics.py", "profile.py", "fig7_speedup.py", "fig9_mapping.py",
            "table2_sequential.py", "fig5_cilkview.py", "ablate_vloss.py",
            "run.py"} <= names


# PyTorch's fused attention and norm are the LM kernels' library yardsticks:
# chip_smoke.py times them in its lm_kernels phase, nothing else calls them
LIBRARY_CALLS = ("scaled_dot_product_attention", "rms_norm")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    forbidden = FORBIDDEN_IN_BENCH if path in BENCH_FILES else FORBIDDEN
    assert not (imported_roots(path) & forbidden)
    text = path.read_text()
    for banned in ("torch.compile", "import triton"):
        assert banned not in text, f"{banned} in {path.name}"
    if path.name != "chip_smoke.py":
        for banned in LIBRARY_CALLS:
            assert banned not in text, f"{banned} in {path.name}"


def test_chip_smoke_calls_library_kernels_only_to_time_them():
    """In chip_smoke.py the library calls appear in the lm_kernels phase
    (the yardstick timing) and nowhere else."""
    path = ROOT / "chip_smoke.py"
    text = path.read_text()
    tree = ast.parse(text)
    inside = set()
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        src = ast.get_source_segment(text, node)
        for name in LIBRARY_CALLS:
            if name in src:
                inside.add((node.name, name))
    assert inside == {("phase_lm_kernels", n) for n in LIBRARY_CALLS}
    assert sum(text.count(n) for n in LIBRARY_CALLS) == sum(
        ast.get_source_segment(text, f).count(n) for f in tree.body
        if isinstance(f, ast.FunctionDef) and f.name == "phase_lm_kernels"
        for n in LIBRARY_CALLS)


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.core.gscpm, repro_torch.core.mcts, "
            "repro_torch.kernels.ops, repro_torch.launch.search, "
            "repro_torch.convert, repro_torch.parity, "
            "repro_torch.serve.mcts_decode, repro_torch.models.api, "
            "repro_torch.configs, repro_torch.configs.hex_paper, "
            "repro_torch.obsv, repro_torch.obsv.profile, "
            "benchmarks_torch.run, benchmarks_torch.fig9_mapping; "
            "from repro_torch.kernels import _build; "
            "assert _build._lib is None; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_cuda_sources_ship_with_the_package():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "uct_select.cu", "hex_winner.cu", "flash_attention.cu", "rmsnorm.cu"}
    for p in csrc.glob("*.cu"):
        assert 'extern "C"' in p.read_text()
        assert "torch/extension.h" not in p.read_text()


NO_GPU = (AssertionError, RuntimeError)   # what torch raises without a card


def test_device_none_means_the_gpu_and_raises_without_one():
    """Nothing falls back to the CPU: every entry point with device=None
    asks for CUDA and fails on a machine that has none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it has none")
    cfg = tg.GSCPMConfig(board_size=5, n_playouts=16, n_tasks=2, n_workers=4,
                         tree_cap=64)
    board = torch.zeros(25, dtype=torch.int8)
    key = rng.key(0, "cpu")
    with pytest.raises(NO_GPU):
        tg.gscpm_search(board, 1, cfg, key)
    with pytest.raises(NO_GPU):
        tmcts.uct_search(board, 1, 4, key, board_size=5, tree_cap=64)
    with pytest.raises(NO_GPU):
        tt.init_tree(64, 25, 1)
    with pytest.raises(NO_GPU):
        rng.key(0)
    with pytest.raises(NO_GPU):
        tsearch.main(["--size", "5", "--playouts", "16"])
    st = tsearch.main(["--size", "5", "--playouts", "32", "--tasks", "4",
                       "--workers", "4", "--device", "cpu"])
    assert st["playouts"] == 32


def test_forest_and_gomoku_entry_points_mean_the_gpu_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it has none")
    cfg = tg.GSCPMConfig(board_size=5, n_playouts=16, n_tasks=2, n_workers=4,
                         tree_cap=64)
    board = torch.zeros(25, dtype=torch.int8)
    key = rng.key(0, "cpu")
    with pytest.raises(NO_GPU):
        trp.gscpm_search_batch(board, 1, cfg, key, n_trees=2)
    with pytest.raises(NO_GPU):
        tt.init_forest(2, 64, 25, 1)
    with pytest.raises(NO_GPU):
        trp.init_sync_state(2, 25)
    with pytest.raises(NO_GPU):
        tg.GSCPMConfig(game="gomoku", board_size=5).game_obj.init_board()
    with pytest.raises(NO_GPU):
        tsearch.main(["--size", "5", "--playouts", "16", "--trees", "2"])
    forest, st = trp.gscpm_search_batch(board, 1, cfg, key, n_trees=2,
                                        device="cpu")
    assert forest.parent.device.type == "cpu" and st["playouts"] == 32


def test_lm_entry_points_mean_the_gpu_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it has none")
    mcfg = tconfigs.reduced_config("smollm-135m")
    with pytest.raises(NO_GPU):
        tapi.init_params(mcfg, seed=0)
    with pytest.raises(NO_GPU):
        tapi.init_cache(mcfg, 2, 8)
    params = tapi.init_params(mcfg, seed=0, device="cpu")
    cfg = tmd.MCTSDecodeConfig(n_workers=2, branch=2, max_depth=2,
                               rollout_len=1, n_playouts=4, n_tasks=2,
                               tree_cap=16)
    prompt = torch.arange(4, dtype=torch.int32)
    with pytest.raises(NO_GPU):
        tmd.mcts_decode_search(params, mcfg, prompt, cfg, rng.key(0, "cpu"))
    with pytest.raises(NO_GPU):
        tmd.mcts_generate(params, mcfg, prompt, 1, cfg, rng.key(0, "cpu"))
    toks, stats = tmd.mcts_generate(params, mcfg, prompt, 1, cfg,
                                    rng.key(0, "cpu"), device="cpu")
    assert toks.shape == (5,) and stats[0]["playouts"] == 4


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""


@pytest.mark.parametrize("over,item", [(dict(metrics=True), "A9")])
def test_out_of_slice_config_raises_not_implemented(over, item):
    """Item A9 (the device counters) is ported: a config with
    ``metrics=True`` runs, and its summary counts the search's playouts."""
    cfg = tg.GSCPMConfig(**{**dict(board_size=5, n_playouts=16, n_tasks=2,
                                   n_workers=4, tree_cap=64), **over})
    tree, st = tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1, cfg,
                               rng.key(0, "cpu"), device="cpu")
    assert st["metrics"]["lane_playouts"] == st["playouts"] == 16
    assert st["metrics"]["expansions"] == int(tree.n_nodes) - 1


def test_out_of_slice_arguments_raise_not_implemented():
    """Item A9 is ported: ``tracer=`` records one span per round on the
    single tree and the forest, and ``metrics=`` accumulators ride through
    ``sync_iteration``, ``run_chunk`` and ``run_chunk_forest``."""
    from repro_torch.obsv import (TraceRecorder, init_search_metrics,
                                  init_search_metrics_forest)
    cfg = tg.GSCPMConfig(board_size=5, n_playouts=16, n_tasks=2, n_workers=4,
                         tree_cap=64)
    on = tg.GSCPMConfig(board_size=5, n_playouts=16, n_tasks=2, n_workers=4,
                        tree_cap=64, metrics=True)
    board = torch.zeros(25, dtype=torch.int8)
    key = rng.key(0, "cpu")
    tracer = TraceRecorder()
    _, st = tg.gscpm_search(board, 1, cfg, key, tracer=tracer, device="cpu")
    assert sum(e["name"] == "gscpm_round" for e in tracer.events) == st[
        "rounds"]
    tree = tt.init_tree(64, 25, 1, device="cpu")
    keys = rng.split(key, 4)
    active = torch.ones(4, dtype=torch.bool)
    tree, m = tg.sync_iteration(tree, board, on, 1.0, keys, active,
                                metrics=init_search_metrics(device="cpu"))
    assert int(m.sync_iterations) == 1 and int(m.lane_playouts) == 4
    tree, m = tg.run_chunk(tree, board, on, keys, active, 2, 1.0, m)
    assert int(m.sync_iterations) == 3 and float(tree.visits[0]) == 12
    tracer = TraceRecorder()
    _, st = trp.gscpm_search_batch(board, 1, cfg, key, n_trees=2,
                                   tracer=tracer, device="cpu")
    assert sum(e["name"] == "gscpm_round" for e in tracer.events) == st[
        "rounds"]
    forest, fm = trp.run_chunk_forest(
        tt.init_forest(2, 64, 25, 1, device="cpu"), board.expand(2, -1), on,
        keys.expand(2, -1, -1), active.expand(2, -1), 1, 1.0,
        init_search_metrics_forest(2, "cpu"))
    assert fm.lane_playouts.tolist() == [4, 4]


@pytest.mark.parametrize("over", [dict(n_trees=2), dict(game="gomoku")],
                         ids=["n_trees", "gomoku"])
def test_config_fields_of_this_slice_run(over):
    """``n_trees`` is a serving-class key that the single-tree search does
    not read (as in the JAX package); Gomoku runs through the protocol."""
    cfg = tg.GSCPMConfig(**{**dict(board_size=5, n_playouts=16, n_tasks=2,
                                   n_workers=4, tree_cap=64), **over})
    tree, st = tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1, cfg,
                               rng.key(0, "cpu"), device="cpu")
    assert float(tree.visits[0]) == st["playouts"] == 16
    seq, _ = tmcts.uct_search(torch.zeros(25, dtype=torch.int8), 1, 4,
                              rng.key(0, "cpu"), board_size=5, game=cfg.game,
                              device="cpu")
    assert float(seq.visits[0]) == 4


@pytest.mark.parametrize("flags,item", [
    (["--metrics"], "A9"), (["--trace", "out.json"], "A9")])
def test_launcher_refuses_out_of_slice_flags(flags, item, tmp_path,
                                             monkeypatch, capsys):
    """Item A9 is ported: ``--metrics`` prints the device counters,
    ``--trace`` writes a trace that ``validate_trace`` accepts."""
    from repro_torch.obsv import validate_trace
    monkeypatch.chdir(tmp_path)
    st = tsearch.main(["--size", "5", "--playouts", "16", "--tasks", "4",
                       "--workers", "4", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    if "--metrics" in flags:
        assert st["metrics"]["lane_playouts"] == 16
        assert "device metrics" in out
    else:
        assert validate_trace(str(tmp_path / "out.json")) == st[
            "trace_events"] > st["rounds"]
        assert "trace:" in out


@pytest.mark.parametrize("flags", [
    ["--game", "gomoku", "--moves", "2"], ["--trees", "3", "--moves", "2"],
    ["--cold", "--moves", "2"], ["--reuse-tree", "--trees", "2"]],
    ids=["gomoku", "forest", "cold", "reuse-forest"])
def test_launcher_runs_this_slices_flags(flags, capsys):
    st = tsearch.main(["--size", "5", "--playouts", "128", "--tasks", "8",
                       "--workers", "8", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    moves = int(flags[flags.index("--moves") + 1]) if "--moves" in flags else 1
    assert len(st["moves_played"]) == moves
    assert all(0 <= m < 25 for m in st["moves_played"])
    if "--trees" in flags:
        assert st["n_trees"] == int(flags[flags.index("--trees") + 1])
        assert "visit-sum" in out
    warm = "--cold" not in flags and moves > 1
    assert ("reused" in out) == warm


@pytest.mark.parametrize("call,item", [
    (lambda: tconfigs.get_config("zamba2-7b"), "A12"),
    (lambda: tconfigs.get_config("deepseek-v2-236b"), "A12"),
    (lambda: tapi.specs(ModelConfig(family="moe", n_experts=4)), "A12"),
    (lambda: tapi.specs(ModelConfig(family="encdec")), "A12"),
    (lambda: tapi.specs(ModelConfig(use_mla=True)), "A12"),
    (lambda: tapi.prefill({}, ModelConfig(), {"tokens": torch.zeros(
        1, 2, dtype=torch.int32), "patches": torch.zeros(1)}, 4), "A12"),
    (lambda: tmd.mcts_decode_search_batch(), "A12b"),
    (lambda: tmd.run_chunk_batch(), "A12b"),
    (lambda: tmd.mcts_generate_batch(), "A12b"),
    (lambda: tengine.SlotEngine(), "A10"),
    (lambda: tengine.MCTSSlotEngine(), "A10"),
    (lambda: ttpfifo.TPFIFODriver(), "A10"),
    (lambda: ttpfifo.TPFIFOEngine(), "A10"),
    (lambda: ttpfifo.TPFIFOMCTSEngine(), "A10"),
    (lambda: tserve.main([]), "A10")],
    ids=["zamba2", "deepseek", "moe", "encdec", "mla", "vlm-extras",
         "search-batch", "chunk-batch", "generate-batch", "slot-engine",
         "mcts-slot-engine", "tpfifo-driver", "tpfifo-engine",
         "tpfifo-mcts-engine", "launch-serve"])
def test_lm_out_of_slice_calls_raise_not_implemented(call, item):
    with pytest.raises(NotImplementedError, match=item):
        call()


def test_attn_chunk_is_refused():
    mcfg = tconfigs.reduced_config("smollm-135m").replace(attn_chunk=4)
    with pytest.raises(NotImplementedError, match="A12"):
        tapi.init_params(mcfg, seed=0, device="cpu")
