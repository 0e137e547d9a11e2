"""The port stands alone: it imports neither jax nor the JAX package (and
its benchmarks and examples not the JAX package's), it runs on the GPU
unless told otherwise, and it refuses by name what it has not ported yet."""

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
from repro_torch.serve import engine as tengine
from repro_torch.serve import mcts_decode as tmd
from repro_torch.serve import tpfifo as ttpfifo

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_FILES = sorted((ROOT / "benchmarks_torch").glob("*.py"))
EXAMPLE_FILES = sorted((ROOT / "examples_torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + BENCH_FILES + EXAMPLE_FILES
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}
# the port's benchmarks and examples are the JAX package's benchmarks' and
# examples' twins, never their callers
FORBIDDEN_IN_BENCH = FORBIDDEN | {"benchmarks", "examples"}


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
            "run.py", "games.py", "resilience.py", "selfplay.py",
            "store.py", "serve_games.py", "serve_chaos.py",
            "kernels_micro.py", "quickstart.py", "root_parallel_demo.py",
            "chaos_serving.py", "trace_serving.py", "serve_mcts.py",
            "_autograd.py", "adamw.py", "pipeline.py", "step.py", "loop.py",
            "train.py", "train_lm.py", "shapes.py", "hw.py", "terms.py",
            "op_costs.py", "inputs.py", "dryrun.py",
            "roofline_table.py", "mesh.py", "rules.py", "collectives.py",
            "render_experiments.py"} <= names
    assert {p.name for p in EXAMPLE_FILES} == {
        "quickstart.py", "root_parallel_demo.py", "serve_games.py",
        "selfplay.py", "chaos_serving.py", "trace_serving.py",
        "serve_mcts.py", "train_lm.py"}


# PyTorch's fused attention and norm are the LM kernels' library yardsticks:
# chip_smoke.py times them in its lm_kernels phase and
# benchmarks_torch/kernels_micro.py beside each kernel; nothing else calls
# them
LIBRARY_CALLS = ("scaled_dot_product_attention", "rms_norm")
YARDSTICK_FILES = (ROOT / "chip_smoke.py",
                   ROOT / "benchmarks_torch" / "kernels_micro.py")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    forbidden = (FORBIDDEN_IN_BENCH if path in BENCH_FILES + EXAMPLE_FILES
                 else FORBIDDEN)
    assert not (imported_roots(path) & forbidden)
    text = path.read_text()
    for banned in ("torch.compile", "import triton"):
        assert banned not in text, f"{banned} in {path.name}"
    if path not in YARDSTICK_FILES:
        for banned in LIBRARY_CALLS:
            assert banned not in text, f"{banned} in {path.name}"


def test_kernels_micro_calls_library_kernels_only_to_time_them():
    """In kernels_micro.py the library calls appear in the module's
    docstring and in the functions timed in turns with the kernels
    (``ms_in_turns``), and nowhere else."""
    path = YARDSTICK_FILES[1]
    text = path.read_text()
    tree = ast.parse(text)
    timed = [ast.get_source_segment(text, node) for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "ms_in_turns"]
    doc = ast.get_docstring(tree, clean=False)
    for name in LIBRARY_CALLS:
        in_timed = sum(seg.count(name) for seg in timed)
        assert in_timed >= 1, name
        assert text.count(name) == in_timed + doc.count(name), name


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
            "repro_torch.serve.games, repro_torch.serve.resilience, "
            "repro_torch.launch.serve, repro_torch.launch.selfplay, "
            "repro_torch.serve.engine, repro_torch.serve.tpfifo, "
            "benchmarks_torch.run, benchmarks_torch.fig9_mapping, "
            "benchmarks_torch.tpfifo, benchmarks_torch.serve_games, "
            "benchmarks_torch.serve_chaos, benchmarks_torch.selfplay, "
            "benchmarks_torch.kernels_micro, repro_torch.data.pipeline, "
            "repro_torch.optim.adamw, repro_torch.train.step, "
            "repro_torch.train.loop, repro_torch.launch.train, "
            "repro_torch.checkpoint.store, repro_torch.configs.shapes, "
            "repro_torch.roofline.terms, repro_torch.roofline.op_costs, "
            "repro_torch.launch.inputs, repro_torch.launch.dryrun, "
            "benchmarks_torch.roofline_table, repro_torch.launch.mesh, "
            "repro_torch.sharding.rules, repro_torch.roofline.collectives, "
            "benchmarks_torch.render_experiments; "
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


def _lm_serving_calls():
    mcfg = tconfigs.reduced_config("smollm-135m")
    params = tapi.init_params(mcfg, seed=0, device="cpu")
    cfg = tmd.MCTSDecodeConfig(n_workers=2, branch=2, max_depth=2,
                               rollout_len=1, n_playouts=4, n_tasks=2,
                               tree_cap=16)
    prompts = torch.ones((2, 4), dtype=torch.int32)
    key = rng.key(0, "cpu")
    return {
        "search-batch": lambda: tmd.mcts_decode_search_batch(
            params, mcfg, prompts, cfg, key),
        "generate-batch": lambda: tmd.mcts_generate_batch(
            params, mcfg, prompts.numpy(), [4, 3], 1, cfg, key),
        "slot-engine": lambda: tengine.SlotEngine(params, mcfg, 2, 16),
        "mcts-slot-engine": lambda: tengine.MCTSSlotEngine(
            params, mcfg, cfg, 2, 8),
        "tpfifo-engine": lambda: ttpfifo.TPFIFOEngine(params, mcfg, 2, 16),
        "tpfifo-mcts-engine": lambda: ttpfifo.TPFIFOMCTSEngine(
            params, mcfg, cfg, 2, 8),
        "lane-state": lambda: ttpfifo.init_lane_state(2, 16, None),
        "launch-serve": lambda: tserve.main(["--requests", "1"]),
        "launch-serve-tpfifo-mcts": lambda: tserve.main(
            ["--requests", "1", "--mcts", "--scheduler", "tpfifo"]),
    }


@pytest.mark.parametrize("call", ["search-batch", "generate-batch",
                                  "slot-engine", "mcts-slot-engine",
                                  "tpfifo-engine", "tpfifo-mcts-engine",
                                  "lane-state", "launch-serve",
                                  "launch-serve-tpfifo-mcts"])
def test_lm_serving_entry_points_mean_the_gpu_and_raise_without_one(call):
    """The batched search, the LM engines and the launcher's LM modes run
    on CUDA unless told ``device="cpu"`` / ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it has none")
    with pytest.raises(NO_GPU):
        _lm_serving_calls()[call]()


def _training_calls():
    import importlib.util
    from repro_torch.launch import train as tlaunch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import loop as tloop
    from repro_torch.train import step as tstep
    mcfg = tconfigs.reduced_config("smollm-135m")
    spec = importlib.util.spec_from_file_location(
        "examples_torch_train_lm", ROOT / "examples_torch" / "train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return {
        "init-params-trainable": lambda: tapi.init_params(
            mcfg, seed=0, requires_grad=True),
        "make-state": lambda: tstep.make_state(mcfg),
        "train": lambda: tloop.train(mcfg, OptConfig(), DataConfig(8, 2),
                                     tloop.LoopConfig(steps=1),
                                     log=lambda s: None),
        "launch-train": lambda: tlaunch.main(["--steps", "1"]),
        "example-train-lm": lambda: example.main(["--steps", "1",
                                                  "--ckpt-dir", "unused"]),
    }


@pytest.mark.parametrize("call", ["init-params-trainable", "make-state",
                                  "train", "launch-train",
                                  "example-train-lm"])
def test_training_entry_points_mean_the_gpu_and_raise_without_one(call):
    """Training runs on CUDA unless told ``device="cpu"`` / ``--device
    cpu`` (the CPU runs are in tests/test_torch_train_loop.py)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule is checked where it has none")
    with pytest.raises(NO_GPU):
        _training_calls()[call]()


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


def _jax_model(arch: str | None, **kw):
    """(JAX config, port config) of a reduced twin or a bare ModelConfig."""
    import dataclasses
    from repro import configs as jconfigs
    from repro.models.common import ModelConfig as JModelConfig
    from repro_torch import convert
    jcfg = (jconfigs.reduced_config(arch).replace(**kw) if arch
            else JModelConfig(**kw))
    return jcfg, convert.model_config_from_dict(dataclasses.asdict(jcfg))


def _specs_equal(arch: str | None, **kw) -> None:
    """The port's spec tree has the reference's leaves, shapes and scales."""
    import jax
    from repro.models import api as japi
    from repro.models.common import Spec
    from repro_torch.models.common import tree_leaves
    jcfg, tcfg = _jax_model(arch, **kw)
    want = {".".join(str(k.key) for k in p): (tuple(s.shape), s.scale)
            for p, s in jax.tree_util.tree_leaves_with_path(
                japi.specs(jcfg), is_leaf=lambda x: isinstance(x, Spec))}
    assert {p: (tuple(s.shape), s.scale)
            for p, s in tree_leaves(tapi.specs(tcfg))} == want


def _prefill_with_patches_on_dense() -> None:
    """A dense model ignores ``patches``, as the reference's prefill does:
    the reference's logits, and the same as without them."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.models import api as japi
    from repro_torch import convert
    jcfg, tcfg = _jax_model("smollm-135m")
    jp = japi.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.arange(1, 7, dtype=np.int32)[None, :]
    patches = np.ones((1, 3, 8), np.float32)
    want, _ = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                      "patches": jnp.asarray(patches)}, 8)
    got, _ = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                     "patches": torch.from_numpy(patches)}, 8)
    plain, _ = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, 8)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("call", [
    lambda: _specs_equal("zamba2-7b", attn_chunk=4),
    lambda: _specs_equal("deepseek-v2-236b", attn_chunk=4),
    lambda: _specs_equal(None, family="moe", n_experts=4, attn_chunk=4),
    lambda: _specs_equal("seamless-m4t-medium"),
    lambda: _specs_equal(None, use_mla=True, attn_chunk=4, q_lora_rank=48,
                         kv_lora_rank=32, qk_nope_head_dim=32,
                         qk_rope_head_dim=16, v_head_dim=32),
    _prefill_with_patches_on_dense],
    ids=["zamba2", "deepseek", "moe", "encdec", "mla", "vlm-extras"])
def test_formerly_refused_lm_calls_match_reference(call):
    """These calls were refused until the vlm and encdec families and
    ``attn_chunk`` were ported; each now runs and equals the reference's."""
    call()


def test_attn_chunk_matches_reference():
    """``attn_chunk`` was refused until ``sdpa_chunked`` was ported: a
    prefill whose 8 tokens the chunk of 4 splits goes through the q-chunked
    path in every layer and equals the reference's, and the unchunked
    causal prefill, within float32 rounding."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.models import api as japi
    from repro_torch import convert
    from repro_torch.models import attention as tattn
    jcfg, mcfg = _jax_model("smollm-135m", attn_chunk=4)
    jp = japi.init_params(jcfg, jax.random.key(1))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), mcfg, "cpu")
    toks = np.arange(3, 11, dtype=np.int32)[None, :]
    chunked = []
    real = tattn.sdpa_chunked
    tattn.sdpa_chunked = lambda *a, **kw: chunked.append(1) or real(*a, **kw)
    try:
        got, _ = tapi.prefill(tp, mcfg, {"tokens": torch.from_numpy(toks)}, 8)
    finally:
        tattn.sdpa_chunked = real
    assert len(chunked) == mcfg.n_layers
    want, _ = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 8)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 * scale, rtol=0)
    plain, _ = tapi.prefill(tp, mcfg.replace(attn_chunk=0),
                            {"tokens": torch.from_numpy(toks)}, 8)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5 * scale,
                               rtol=0)
