"""The sharded dry-run (``repro_torch.launch.{mesh, inputs, dryrun}`` on
the production meshes, ``benchmarks_torch.render_experiments``) against the
JAX package's.

- **Shard coverage.** For every leaf of a reduced cell's params or state,
  batch, tokens, positions and cache, on a (4, 2) ("data", "model") mesh,
  rank r's local shard (``sharding.rules.distribute_to``, its offset as
  DTensor computes it) covers exactly the index range that the reference's
  ``NamedSharding(...).devices_indices_map(shape)`` gives device r. The JAX
  side runs in a subprocess with 8 host devices.
- **Per-chip counts.** A reduced cell's per-rank matmul FLOPs on that mesh
  against the reference's per-chip dot FLOPs of ``lower_cell(...)
  .compile()``, and the collective wire bytes side by side.
- **Card counts do not move.** Every decode and long-context one-card
  cell's count, and six prefill and train cells', equal the committed
  ``artifacts/dryrun_torch/*__card.json`` exactly.
- The sLSTM loop counted by one scaled token step, the production meshes,
  the rules, the CLI and the rendered summary.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import inputs as jinputs
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import mesh as lmesh
from repro_torch.sharding import rules as shr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "dryrun_torch")
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
KNOBS = ("name", "logits_chunk", "attn_chunk", "remat")
FAMILIES = {"dense": "smollm-135m", "moe": "qwen3-moe-235b-a22b",
            "hybrid": "zamba2-7b", "xlstm": "xlstm-1.3b",
            "vlm": "paligemma-3b", "encdec": "seamless-m4t-medium"}


def reduced(arch: str) -> dict:
    """The reduced twin's widths as overrides (the shape's knobs kept)."""
    return {k: v for k, v in
            dataclasses.asdict(tconfigs.reduced_config(arch)).items()
            if k not in KNOBS}


COVER_CELLS = [(a, s) for a in FAMILIES.values()
               for s in ("train_4k", "prefill_32k", "decode_32k")] + [
    ("zamba2-7b", "long_500k")]

COVER_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.compat import make_auto_mesh
from repro.launch import inputs
from repro.sharding import rules as shr
mesh = make_auto_mesh((4, 2), ("data", "model"))
devs = list(mesh.devices.flat)
cells = json.loads(sys.argv[1])
def path(p):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
out = {}
for arch, shape, ov in cells:
    spec = inputs.input_specs(arch, shape, ov)
    rules = spec["rules"]
    trees = []
    if "state" in spec:
        trees.append(("", spec["state"], inputs.shardings_for(
            mesh, spec["state"], spec["state_axes"], rules)))
    else:
        trees.append(("", spec["params"], inputs.shardings_for(
            mesh, spec["params"], spec["param_axes"], rules)))
    if "batch" in spec:
        trees.append(("", spec["batch"], inputs.batch_shardings_for(
            mesh, spec["batch"], rules)))
    if "cache" in spec:
        trees.append(("cache.", spec["cache"], inputs.shardings_for(
            mesh, spec["cache"], spec["cache_axes"], rules)))
        for k, axes in (("tokens", ("batch", None)), ("pos", ("batch",))):
            sds = spec[k]
            trees.append(("", {k: sds}, {k: shr.named_sharding_for(
                mesh, axes, tuple(sds.shape), rules)}))
    leaves = {}
    for pre, sds, sh in trees:
        for (p, s), (_, n) in zip(
                jax.tree_util.tree_leaves_with_path(sds),
                jax.tree_util.tree_leaves_with_path(sh)):
            m = n.devices_indices_map(tuple(s.shape))
            leaves[pre + path(p)] = [
                [[sl.start or 0, s.shape[i] if sl.stop is None else sl.stop]
                 for i, sl in enumerate(m[d])] for d in devs]
    out[f"{arch}/{shape}"] = leaves
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_ranges():
    cells = [(a, s, reduced(a)) for a, s in COVER_CELLS]
    out = subprocess.run([sys.executable, "-c", COVER_SCRIPT,
                          json.dumps(cells)], capture_output=True, text=True,
                         env=ENV, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def port_leaves(spec) -> list:
    """(path, tensor, logical axes) of every input of a cell, with the
    reference's paths (the cache under ``cache.``)."""
    out = []
    if "state" in spec:
        out += list(tinputs._paired(spec["state"], spec["state_axes"]))
    else:
        out += list(tinputs._paired(spec["params"], spec["param_axes"]))
    if "batch" in spec:
        out += list(tinputs._paired(spec["batch"], None))
    if "cache" in spec:
        out += [("cache." + p, t, a) for p, t, a in
                tinputs._paired(spec["cache"], spec["cache_axes"])]
        out += [("tokens", spec["tokens"], ("batch", None)),
                ("pos", spec["pos"], ("batch",))]
    return out


@pytest.fixture(scope="module")
def port_ranges():
    """{cell: {path: [per rank: [[start, stop] a dim]]}} from DTensor: each
    rank in turn is rank r of a fake group of 8, and its shard's offset and
    shape are DTensor's own (``compute_local_shape_and_global_offset``)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    out: dict = {f"{a}/{s}": {} for a, s in COVER_CELLS}
    for r in range(8):
        with lmesh.fake_process_group(8, rank=r):
            mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                              mesh_dim_names=("data", "model"))
            for arch, shape in COVER_CELLS:
                spec = tinputs.input_specs(arch, shape, reduced(arch))
                for path, t, axes in port_leaves(spec):
                    d = shr.distribute_to(mesh, t, axes, spec["rules"])
                    shp, off = compute_local_shape_and_global_offset(
                        tuple(t.shape), mesh, d.placements)
                    assert tuple(d.to_local().shape) == tuple(shp), path
                    out[f"{arch}/{shape}"].setdefault(path, []).append(
                        [[o, o + n] for o, n in zip(off, shp)])
    return out


@pytest.mark.parametrize("arch,shape", COVER_CELLS)
def test_each_ranks_shard_covers_the_references_device_range(
        jax_ranges, port_ranges, arch, shape):
    want, got = jax_ranges[f"{arch}/{shape}"], port_ranges[f"{arch}/{shape}"]
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for path in want:
        assert got[path] == want[path], path
    # the cell splits something: some leaf's ranks hold different blocks
    assert any(r != v[0] for v in want.values() for r in v)


# -------------------------------------------------- per-chip counts ----
FLOPS_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.compat import make_auto_mesh
from repro.launch import dryrun
from repro.roofline import hlo_costs
arch, shape, ov = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
mesh = make_auto_mesh((4, 2), ("data", "model"))
lowered, *_ = dryrun.lower_cell(arch, shape, mesh, unroll=False,
                                cfg_overrides=ov)
hlo = lowered.compile().as_text()
keep = {"dot", "while", "conditional", "call", "fusion", "parameter",
        "constant", "tuple", "get-tuple-element"}
def only_dots(line):
    m = hlo_costs._INSTR.match(line)
    if not m or m.group(3) in keep:
        return line
    return line[:m.start(3)] + "bitcast" + line[m.end(3):]
dots = "\n".join(only_dots(l) for l in hlo.splitlines())
full = hlo_costs.rollup(hlo)
print(json.dumps({"dot_flops": hlo_costs.rollup(dots).flops,
                  "wire": full.coll_wire, "by_op": full.coll_by_op}))
"""

# tests/test_dryrun.py's reduced widths
REDUCED = {"n_layers": 2, "d_model": 256, "n_heads": 4, "n_kv_heads": 2,
           "d_ff": 512, "vocab": 4096}
# (arch, shape, the largest relative gap of the per-chip matmul FLOPs):
# decode and prefill split the same matmuls; the train step's gap is the
# one-card cell's (the compiled reference recomputes QK^T once more in its
# backward than the port's remat: 7.6 %) plus slack for the partitioner's
# choices
CROSS = [("smollm-135m", "decode_32k", 0.10),
         ("qwen1.5-0.5b", "prefill_32k", 0.10),
         ("smollm-135m", "train_4k", 0.12)]


@pytest.mark.parametrize("arch,shape,tol", CROSS)
def test_per_rank_matmul_flops_match_the_references_per_chip_dots(
        arch, shape, tol):
    """Per-rank matmul FLOPs of a reduced cell on the (4, 2) mesh against
    the reference's per-chip dot FLOPs (``hlo_costs.rollup`` of the
    compiled SPMD module). The wire bytes are printed beside the
    reference's and held within 0.1x-10x of them: the two partitioners
    choose different collectives for the same annotations (DTensor moves a
    sequence split by all-to-all and re-splits gathered weights where XLA
    may keep a partial sum), so only their order of magnitude is shared."""
    from torch.distributed.device_mesh import DeviceMesh
    out = subprocess.run([sys.executable, "-c", FLOPS_SCRIPT, arch, shape,
                          json.dumps(REDUCED)], capture_output=True,
                         text=True, env=ENV, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    with lmesh.fake_process_group(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                          mesh_dim_names=("data", "model"))
        res = dryrun.analyze_cell(arch, shape, "single",
                                  cfg_overrides=REDUCED, mesh=mesh)
    got = res["cost"]["matmul_flops"]
    wire = res["collectives"]["wire_bytes"]
    print(f"{arch} {shape}: matmul {got:.4e} / ref {ref['dot_flops']:.4e}; "
          f"wire {wire:.4e} / ref {ref['wire']:.4e}; by op "
          f"{res['collectives']['by_op']} / {ref['by_op']}")
    assert abs(got - ref["dot_flops"]) <= tol * ref["dot_flops"], (got, ref)
    assert res["chips"] == 8 and res["mesh_dims"] == {"data": 4, "model": 2}
    assert 0.1 * ref["wire"] <= wire <= 10 * ref["wire"], (wire, ref)


# ------------------------------------------------------ card counts ----
# every decode and long-context card cell, and the quicker prefill and
# train cells of a dense, an MoE and the xLSTM family
CARD = sorted(f[:-len("__card.json")].split("__")
              for f in os.listdir(ART) if f.endswith("__card.json")
              and f.split("__")[1] in ("decode_32k", "long_500k")) + [
    ["qwen1.5-0.5b", "prefill_32k"], ["qwen1.5-0.5b", "train_4k"],
    ["smollm-135m", "train_4k"], ["qwen3-moe-235b-a22b", "prefill_32k"],
    ["xlstm-1.3b", "prefill_32k"], ["xlstm-1.3b", "train_4k"]]


@pytest.mark.parametrize("arch,shape", CARD)
def test_card_counts_do_not_move(arch, shape):
    """The one-card count equals the committed JSON figure for figure (the
    count's own time aside): FLOPs, bytes, kernel calls, peak, and every
    figure derived from them."""
    with open(os.path.join(ART, f"{arch}__{shape}__card.json")) as f:
        want = json.load(f)
    got = json.loads(json.dumps(dryrun.analyze_cell(arch, shape)))
    got.pop("timing"), want.pop("timing")
    assert got == want


# ------------------------------------------------------- sLSTM loop ----
def _count(arch, shape, ov, cut, full_loop: bool, monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.roofline.op_costs import OpCosts
    with monkeypatch.context() as m:
        if full_loop:           # the counter runs every token step
            m.setattr(OpCosts, "token_loop",
                      lambda self, step, trips, state, inputs:
                      ops.full_loop(step, trips, state))
        return dryrun.analyze_cell(arch, shape, cfg_overrides=ov,
                                   shape_overrides=cut)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_the_slstm_loop_is_counted_by_one_scaled_token_step(shape,
                                                            monkeypatch):
    """At 64 tokens, one sLSTM token step charged 64 times against the
    loop run in full. Prefill (no gradient): FLOPs, bytes, kernel calls
    and the peak equal. Train: the step's backward is charged 64 times as
    well, and the kernel calls and transcendentals equal; FLOPs and bytes
    within 0.3 % and 1 %, the peak within 1 %: the full loop's autograd
    also adds each token's gradient slice into the gates' (B, L, d)
    gradients one by one (L - 1 adds a gate), which one scaled step does
    not replay."""
    ov = {"n_layers": 8, "d_model": 128}
    cut = {"seq_len": 64, "global_batch": 2}
    s = _count("xlstm-1.3b", shape, ov, cut, False, monkeypatch)
    f = _count("xlstm-1.3b", shape, ov, cut, True, monkeypatch)
    assert s["cost"]["while_trips"] and not f["cost"]["while_trips"]
    assert s["kernels"] == f["kernels"]
    sc, fc = s["cost"], f["cost"]
    if shape == "prefill_32k":
        for k in ("parsed_flops_per_chip", "parsed_bytes_per_chip",
                  "parsed_bytes_upper_bound", "parsed_transcendentals",
                  "matmul_flops"):
            assert sc[k] == fc[k], k
        assert s["memory"] == f["memory"]
        return
    assert sc["parsed_transcendentals"] == fc["parsed_transcendentals"]
    assert abs(sc["parsed_flops_per_chip"] / fc["parsed_flops_per_chip"]
               - 1) < 3e-3
    assert abs(sc["parsed_bytes_per_chip"] / fc["parsed_bytes_per_chip"]
               - 1) < 1e-2
    assert abs(s["memory"]["peak_bytes_per_chip"]
               / f["memory"]["peak_bytes_per_chip"] - 1) < 1e-2


def test_the_xlstm_cells_are_counted_on_one_card():
    for shape in ("prefill_32k", "train_4k"):
        with open(os.path.join(ART, f"xlstm-1.3b__{shape}__card.json")) as f:
            cell = json.load(f)
        assert "error" not in cell, cell
        assert cell["cost"]["while_trips"]
        assert cell["kernels"]["calls"]["rmsnorm"] > 0


# ------------------------------------------------ meshes and rules ----
def test_production_meshes_over_a_fake_world_of_512():
    with lmesh.fake_process_group():
        single = lmesh.make_production_mesh()
        multi = lmesh.make_production_mesh(multi_pod=True)
        assert lmesh.mesh_dims(single) == {"data": 16, "model": 16}
        assert lmesh.mesh_dims(multi) == {"pod": 2, "data": 16, "model": 16}
        assert single.size() == 256 and multi.size() == 512
        assert lmesh.axis_names(multi) == ("pod", "data", "model")
        assert shr.is_lm_mesh(single) and not shr.is_lm_mesh(
            lmesh.make_ensemble_mesh(["cpu"]))
    import torch.distributed as dist
    assert not dist.is_initialized()
    with lmesh.fake_process_group(64):
        with pytest.raises(RuntimeError, match="fake process group of 512"):
            lmesh.make_production_mesh()


@pytest.mark.parametrize("shape", list(tconfigs.SHAPES))
def test_rules_for_shape_equal_the_reference(shape):
    assert tinputs.rules_for_shape(tconfigs.SHAPES[shape]) == \
        jinputs.rules_for_shape(jconfigs.SHAPES[shape])


def test_shardings_for_give_the_reference_specs():
    """``shardings_for`` and ``batch_shardings_for`` against the reference's
    specs, on a duck-typed (16, 16) mesh (the reference's rule functions
    read only a mesh's names and shape)."""
    import types
    from repro.sharding import rules as jrules
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16), dtype=object))
    spec = tinputs.input_specs("llama3-8b", "decode_32k")
    rules = spec["rules"]
    got = tinputs.shardings_for(mesh, spec["cache"], spec["cache_axes"],
                                rules)
    for (path, t, axes), (p2, s) in zip(
            tinputs._paired(spec["cache"], spec["cache_axes"]), _flat(got)):
        assert p2 == path
        want = jrules._divisible_spec(jrules.logical_to_spec(
            axes, rules, mesh), tuple(t.shape), mesh)
        assert tuple(s.spec) == tuple(want), path
    b = tinputs.batch_shardings_for(mesh, {"tokens": spec["tokens"]}, rules)
    assert tuple(b["tokens"].spec) == ("data", None)


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{pre}{k}.")
        else:
            yield f"{pre}{k}", v


def test_input_specs_on_a_mesh_hold_rank_0s_share():
    from torch.distributed.tensor import DTensor
    with lmesh.fake_process_group():
        mesh = lmesh.make_production_mesh()
        spec = tinputs.input_specs("llama3-8b", "decode_32k", mesh=mesh)
        wq = spec["params"]["stage_0"]["attn"]["wq"]
        assert isinstance(wq, DTensor) and wq.to_local().is_meta
        # (layers, embed / 16 data, heads / 16 model, hd)
        assert tuple(wq.to_local().shape) == (32, 256, 2, 128)
        k = spec["cache"]["stage_0"]["k"]
        # (layers, batch / 16, kv_len / 16, kv heads whole, hd)
        assert tuple(k.to_local().shape) == (32, 8, 2048, 8, 128)
        assert tuple(spec["tokens"].to_local().shape) == (8, 1)
        assert set(spec) >= {"param_axes", "cache_axes", "rules"}


# -------------------------------------------------- CLI and summary ----
def test_the_cli_counts_a_multipod_cell_with_the_references_keys(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--multi-pod", "--out",
         str(tmp_path)], capture_output=True, text=True, env=ENV,
        timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / "smollm-135m__decode_32k__multipod.json") as f:
        cell = json.load(f)
    assert cell["mesh"] == "multipod" and cell["chips"] == 512
    assert cell["mesh_dims"] == {"pod": 2, "data": 16, "model": 16}
    c = cell["collectives"]
    assert c["wire_bytes"] > 0 and c["count"] == c["flat_structure"]["count"]
    assert set(c["by_op"]) == set(c["flat_structure"]["by_op"])
    r = cell["roofline"]
    assert r["collective_s"] > 0 and "lower bound" in r["collective_note"]
    assert r["chips"] == 512 and cell["memory"]["fits_hbm"]


def test_render_experiments_reads_the_committed_sweep():
    from benchmarks_torch import render_experiments
    res = render_experiments.run()
    assert res["n_cells"] >= 96
    assert "single-pod cells** counted on the 16×16 mesh" in \
        res["dryrun_summary"]
    assert "fit 80 GB a chip" in res["dryrun_summary"]
    assert res["roofline_table"].startswith("| arch | shape |")
    assert "memory-bound" in res["roofline_notes"]
