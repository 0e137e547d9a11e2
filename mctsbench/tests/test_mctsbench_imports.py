"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` begins with ``repro``),
and the reference imports nothing of the program either."""

import ast
import json
import subprocess
import sys

from mctsbench.manifest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = ROOT / "mctsbench"


def loaded_after(code: str) -> set:
    """Top-level names of every module loaded after running ``code`` in a
    fresh interpreter."""
    prog = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n{code}\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(json.dumps(sorted(tops)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runner_and_readers_load_no_jax():
    code = """
from mctsbench import run, harness, program, trace, control, work, device
from mctsbench.manifest import Manifest
m = Manifest()
for folder in ("metrics", "costs", "probes", "traffic"):
    m.named(folder, [p.stem for p in (m.bench / folder).glob("*.py")])
import repro_torch.kernels.ops
"""
    top = loaded_after(code)
    assert "repro_torch" in top and "torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = """
from mctsbench.reference import threefry, games, search, compare
"""
    top = loaded_after(code)
    assert not top & (FORBIDDEN | {"repro_torch"})


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_names_a_forbidden_module():
    for path in BENCH.rglob("*.py"):
        tops = set(imported_tops(path))
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path


def test_forbidden_check_compares_whole_names():
    from mctsbench import harness
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torchlike"] = sys
        sys.modules["repro.core"] = sys
        assert harness.forbidden_modules() == ["repro.core"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
