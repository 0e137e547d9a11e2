"""The port stands alone: it imports neither jax nor the JAX package, it
runs on the GPU unless told otherwise, and it refuses by name what it has
not ported yet."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import rng
from repro_torch.core import gscpm as tg
from repro_torch.core import mcts as tmcts
from repro_torch.core import tree as tt
from repro_torch.launch import search as tsearch

# tiny tensors: intra-op threads only fight the other test workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


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
            "chip_smoke.py", "convert.py", "search.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    assert not (imported_roots(path) & FORBIDDEN)
    text = path.read_text()
    for banned in ("torch.compile", "scaled_dot_product_attention",
                   "import triton"):
        assert banned not in text, f"{banned} in {path.name}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.core.gscpm, repro_torch.core.mcts, "
            "repro_torch.kernels.ops, repro_torch.launch.search, "
            "repro_torch.convert, repro_torch.parity; "
            "from repro_torch.kernels import _build; "
            "assert _build._lib is None; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_cuda_sources_ship_with_the_package():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {"uct_select.cu",
                                                   "hex_winner.cu"}
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


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""


@pytest.mark.parametrize("over,item", [
    (dict(metrics=True), "A9"), (dict(n_trees=2), "A7"),
    (dict(game="gomoku"), "A6")])
def test_out_of_slice_config_raises_not_implemented(over, item):
    cfg = tg.GSCPMConfig(**{**dict(board_size=5, n_playouts=16, n_tasks=2,
                                   n_workers=4, tree_cap=64), **over})
    with pytest.raises(NotImplementedError, match=item):
        tg.gscpm_search(torch.zeros(25, dtype=torch.int8), 1, cfg,
                        rng.key(0, "cpu"), device="cpu")


def test_out_of_slice_arguments_raise_not_implemented():
    cfg = tg.GSCPMConfig(board_size=5, n_playouts=16, n_tasks=2, n_workers=4,
                         tree_cap=64)
    board = torch.zeros(25, dtype=torch.int8)
    key = rng.key(0, "cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tg.gscpm_search(board, 1, cfg, key, tracer=object(), device="cpu")
    tree = tt.init_tree(64, 25, 1, device="cpu")
    keys = rng.split(key, 4)
    active = torch.ones(4, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="A9"):
        tg.sync_iteration(tree, board, cfg, 1.0, keys, active, metrics=object())
    with pytest.raises(NotImplementedError, match="A9"):
        tg.run_chunk(tree, board, cfg, keys, active, 1, 1.0, object())
    with pytest.raises(NotImplementedError, match="A6"):
        tmcts.uct_search(board, 1, 4, key, board_size=5, game="gomoku",
                         device="cpu")


@pytest.mark.parametrize("flags,item", [
    (["--trees", "2"], "A7"), (["--moves", "2"], "A8"),
    (["--metrics"], "A9"), (["--trace", "out.json"], "A9"),
    (["--game", "gomoku"], "A6")])
def test_launcher_refuses_out_of_slice_flags(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        tsearch.main(["--size", "5", "--playouts", "16", "--device", "cpu",
                      *flags])
