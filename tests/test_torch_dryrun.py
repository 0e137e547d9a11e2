"""The port's one-card dry-run (``repro_torch.launch.{inputs, dryrun}``,
``benchmarks_torch.roofline_table``) against the JAX package's: the
``meta`` inputs of every cell equal the reference's ``ShapeDtypeStruct``s,
the counted FLOPs of three reduced cells equal the reference's compiled
HLO's, every family's train, prefill and decode cells count end to end,
and the repairs that let a step run on ``meta`` (``optim.adamw.lr_at``,
``models.attention.check_positions``, ``train.step.abstract_state``)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import inputs as jinputs
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as tinputs
from repro_torch.models import attention as tattn
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in jconfigs.ARCHS for s in jconfigs.SHAPES
         if jconfigs.applicable(jconfigs.get_config(a),
                                jconfigs.SHAPES[s])[0]]
# tests/test_dryrun.py's reduced widths
REDUCED = {"n_layers": 2, "d_model": 256, "n_heads": 4, "n_kv_heads": 2,
           "d_ff": 512, "vocab": 4096}


def _jax_leaves(tree) -> dict:
    return {".".join(str(k.key) for k in path): (tuple(v.shape),
                                                 str(v.dtype))
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree) -> dict:
    out = {}
    for path, v in tree_leaves(tree):
        if hasattr(v, "tree"):
            v = v.tree()
        if isinstance(v, dict):
            out.update({f"{path}.{p}": leaf
                        for p, leaf in _port_leaves(v).items()})
        else:
            out[path] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


# ------------------------------------------------------------------ inputs ----
def test_input_specs_all_cells_count():
    """The twin of ``tests/test_dryrun.py::test_input_specs_all_cells``:
    32 of the 40 cells run, the rest are the full-attention long_500k
    skips."""
    n = 0
    for arch in tconfigs.ARCHS:
        cfg = tconfigs.get_config(arch)
        for sname, sh in tconfigs.SHAPES.items():
            ok, why = tconfigs.applicable(cfg, sh)
            if not ok:
                assert "full-attn" in why
                continue
            n += 1
    assert n == len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference_and_allocate_nothing(arch, shape):
    """Every leaf of the cell's inputs — state or params, batch, decode
    tokens, positions and cache — has the reference's path, shape and
    dtype, on ``meta``; the train cell's params require grad."""
    t = tinputs.input_specs(arch, shape)
    j = jinputs.input_specs(arch, shape)
    assert dataclasses.asdict(t["cfg"]) == dataclasses.asdict(j["cfg"])
    assert t["shape"] == tconfigs.SHAPES[shape]
    tensors = []
    if shape == "train_4k":
        for k in ("moment_dtype", "accum_dtype", "n_microbatches"):
            assert t[k] == j[k], k
        state = {"params": t["state"]["params"].tree(),
                 "opt": t["state"]["opt"]}
        assert _port_leaves(state) == _jax_leaves(j["state"])
        assert all(p.requires_grad for p in t["state"]["params"].parameters())
        tensors = list(t["state"]["params"].parameters())
    else:
        assert _port_leaves(t["params"]) == _jax_leaves(j["params"])
        tensors = [v for _, v in tree_leaves(t["params"])]
    if "batch" in j:
        assert _port_leaves(t["batch"]) == _jax_leaves(j["batch"])
        tensors += list(t["batch"].values())
    if "cache" in j:
        assert _port_leaves(t["cache"]) == _jax_leaves(j["cache"])
        for k in ("tokens", "pos"):
            assert (tuple(t[k].shape), t[k].dtype) == (j[k].shape,
                                                       torch.int32)
        tensors += [v for _, v in tree_leaves(t["cache"])]
    assert tensors and all(v.device.type == "meta" for v in tensors)


def test_sharding_names_work_on_the_production_meshes(tmp_path):
    """``rules_for_shape``, ``shardings_for`` and ``batch_shardings_for``
    give a cell's rules and placements, and the dry-run counts it on the
    multi-pod mesh (the CLI's ``--multi-pod``)."""
    from repro_torch.launch import mesh as lmesh
    rules = tinputs.rules_for_shape(tconfigs.SHAPES["decode_32k"])
    assert rules["kv_len"] == "model"
    spec = tinputs.input_specs("smollm-135m", "decode_32k")
    with lmesh.fake_process_group():
        mesh = lmesh.make_production_mesh(multi_pod=True)
        sh = tinputs.shardings_for(mesh, spec["cache"], spec["cache_axes"],
                                   rules)
        k = sh["stage_0"]["k"]
        assert tuple(k.spec) == (None, ("pod", "data"), "model", None, None)
        assert len(k.placements) == 3
        b = tinputs.batch_shardings_for(mesh, {"tokens": spec["tokens"]},
                                        rules)
        assert tuple(b["tokens"].spec) == (("pod", "data"), None)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                     "--multi-pod", "--out", str(tmp_path)])
    assert done.value.code == 0
    with open(tmp_path / "smollm-135m__decode_32k__multipod.json") as f:
        assert json.load(f)["chips"] == 512


# --------------------------------------------------- counts against JAX ----
JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.devices()          # one CPU device, before dryrun's 512-device flag
from repro.compat import make_auto_mesh
from repro.launch import dryrun
from repro.roofline import hlo_costs
arch, shape, ov = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
mesh = make_auto_mesh((1, 1), ("data", "model"))
lowered, *_ = dryrun.lower_cell(arch, shape, mesh, unroll=False,
                                cfg_overrides=ov)
hlo = lowered.compile().as_text()
# the same HLO with every instruction but the dots (and the control flow
# and fusions that call them) turned into a free bitcast: its rollup is the
# dots' FLOPs, loop trips included
keep = {"dot", "while", "conditional", "call", "fusion", "parameter",
        "constant", "tuple", "get-tuple-element"}
def only_dots(line):
    m = hlo_costs._INSTR.match(line)
    if not m or m.group(3) in keep:
        return line
    return line[:m.start(3)] + "bitcast" + line[m.end(3):]
dots = "\n".join(only_dots(l) for l in hlo.splitlines())
print(json.dumps({"flops": hlo_costs.rollup(hlo).flops,
                  "dot_flops": hlo_costs.rollup(dots).flops}))
"""

# (arch, shape, the largest relative gap of the matmul FLOPs). The decode
# and prefill programs are the same matmuls to the FLOP. The train step's
# differs by one pass: the compiled reference recomputes the attention
# scores (QK^T) once more in its backward than the port's remat does,
# 2 * B * H * S^2 * hd * n_layers = 4.4e12 of 5.77e13 (7.6 %).
CROSS = [("smollm-135m", "train_4k", 0.10),
         ("smollm-135m", "decode_32k", 1e-9),
         ("qwen1.5-0.5b", "prefill_32k", 1e-9)]


@pytest.mark.parametrize("arch,shape,tol", CROSS)
def test_counted_flops_match_the_reference_dry_run(arch, shape, tol):
    """The port's op count of a reduced cell (``use_flash`` off, the
    reference's dry-run widths) against ``hlo_costs.rollup`` of the JAX
    cell compiled on one CPU device, in a subprocess (the reference's
    dry-run sets a 512-device ``XLA_FLAGS``). The matmul FLOPs agree
    within ``tol``; the port's total lies between 0.9x the reference's
    dot FLOPs and the reference's total, whose elementwise count is
    XLA:CPU's (converts and copies of the whole cache, broadcasts)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", JAX_SCRIPT, arch, shape,
                          json.dumps(REDUCED)], capture_output=True,
                         text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    res = dryrun.analyze_cell(arch, shape, cfg_overrides=REDUCED)
    got, got_mm = (res["cost"]["parsed_flops_per_chip"],
                   res["cost"]["matmul_flops"])
    assert abs(got_mm - ref["dot_flops"]) <= tol * ref["dot_flops"], (
        got_mm, ref)
    assert 0.9 * ref["dot_flops"] <= got <= ref["flops"], (got, ref)


# ---------------------------------------------------------- end to end ----
FAMILIES = {"dense": "smollm-135m", "moe": "qwen3-moe-235b-a22b",
            "hybrid": "zamba2-7b", "xlstm": "xlstm-1.3b",
            "vlm": "paligemma-3b", "encdec": "seamless-m4t-medium"}
KNOBS = ("name", "logits_chunk", "attn_chunk", "remat")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_analyze_cell_counts_a_reduced_twin_of_every_family(family, shape,
                                                            tmp_path):
    """The family's reduced twin (``tune_for_shape``'s knobs kept) at 64
    tokens: the step runs on ``meta`` under the count and the cell's JSON
    is well formed — positive FLOPs and bytes, the roofline's terms, a
    peak at least the arguments, the kernels it calls."""
    arch = FAMILIES[family]
    ov = {k: v for k, v in
          dataclasses.asdict(tconfigs.reduced_config(arch)).items()
          if k not in KNOBS}
    cut = {"seq_len": 64, "global_batch": 2}
    [res] = dryrun.run_cells([(arch, shape, "card")], str(tmp_path),
                             cfg_overrides=ov, shape_overrides=cut)
    assert "error" not in res, res
    with open(tmp_path / f"{arch}__{shape}__card.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    r, mem, cost = res["roofline"], res["memory"], res["cost"]
    assert res["chips"] == 1 and res["mesh"] == "card"
    assert res["overrides"]["shape"] == cut
    assert 0 < cost["matmul_flops"] <= r["flops_per_chip"]
    assert 0 < r["hbm_bytes_per_chip"] <= cost["parsed_bytes_upper_bound"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] == 0
    assert r["bottleneck"] in ("compute", "memory")
    assert mem["peak_bytes_per_chip"] >= mem["argument_bytes"] > 0
    assert mem["fits_hbm"]
    calls = res["kernels"]["calls"]
    assert calls["rmsnorm"] > 0 or family == "encdec"
    if shape == "train_4k":
        assert mem["alias_bytes"] > 0          # the state, updated in place
        assert res["kernels"]["plain_backwards"]["rmsnorm"] > 0 \
            or family == "encdec"


def test_xlstm_cells_are_counted_by_a_scaled_token_step(tmp_path):
    """The xLSTM cells whose sLSTM token loop is too long to run on
    ``meta`` count: one token step charged as every one
    (``while_trips``)."""
    ov = {"n_layers": 8, "d_model": 128}
    results = dryrun.run_cells([("xlstm-1.3b", "train_4k", "card"),
                                ("xlstm-1.3b", "prefill_32k", "card")],
                               str(tmp_path), cfg_overrides=ov,
                               shape_overrides={"seq_len": 128,
                                                "global_batch": 2})
    assert all("error" not in r for r in results), results
    assert [r["cost"]["while_trips"] for r in results] == [[128, 128], [128]]
    assert len(list(tmp_path.iterdir())) == 2


def test_the_cli_writes_the_reference_cells_keys_and_the_table_renders(
        tmp_path):
    """``python -m repro_torch.launch.dryrun --arch smollm-135m --shape
    train_4k --card`` writes the cell with the JAX cell's keys
    (``fits_hbm`` for ``fits_16GiB``), and ``roofline_table`` renders it."""
    from benchmarks_torch import roofline_table
    from repro.roofline import terms as jterms
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "train_4k", "--card", "--out",
         str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "1/1 cells OK" in out.stdout
    with open(tmp_path / "smollm-135m__train_4k__card.json") as f:
        cell = json.load(f)
    assert set(cell) >= {"arch", "shape", "mesh", "mesh_dims", "chips",
                         "kind", "n_params", "n_params_active", "memory",
                         "cost", "collectives", "roofline", "timing",
                         "overrides"}
    assert set(cell["memory"]) == {"argument_bytes", "output_bytes",
                                   "temp_bytes", "alias_bytes",
                                   "peak_bytes_per_chip", "fits_hbm"}
    assert set(cell["cost"]) >= {
        "parsed_flops_per_chip", "parsed_bytes_per_chip",
        "parsed_bytes_upper_bound", "parsed_transcendentals",
        "xla_flat_flops", "xla_flat_bytes",
        "crosscheck_unrolled_global_flops", "while_trips"}
    assert set(cell["collectives"]) == {"count", "operand_bytes",
                                        "wire_bytes", "by_op",
                                        "flat_structure"}
    ref_keys = jterms.RooflineTerms(1.0, 1.0, 0.0, 1, 1.0, 0.0).to_dict()
    assert set(cell["roofline"]) == set(ref_keys)
    assert cell["kernels"]["calls"]["rmsnorm"] == 2 * 61 - 1   # remat
    table = roofline_table.run(str(tmp_path))
    assert (table["n_cells"], table["n_ok"]) == (1, 1)
    row = table["table_card"].splitlines()[2]
    assert row.startswith("| smollm-135m | train_4k |") and "memory" in row


def test_roofline_table_lists_error_cells_under_the_table():
    cells = [{"arch": "xlstm-1.3b", "shape": "train_4k", "mesh": "card",
              "error": "not counted: the sLSTM token loop"},
             {"arch": "x", "shape": "y", "mesh": "multipod", "error": "no"}]
    from benchmarks_torch import roofline_table
    text = roofline_table.render(cells)
    assert len(text.splitlines()) == 4
    assert text.splitlines()[-1] == ("- xlstm-1.3b x train_4k: not counted: "
                                     "the sLSTM token loop")
    assert roofline_table.fmt_s(2.5) == "2.50s"
    assert roofline_table.fmt_s(0.0123) == "12.30ms"
    assert roofline_table.fmt_s(4.5e-6) == "4.5us"


def test_the_aggregator_quick_job_dry_runs_and_renders_a_cell(
        tmp_path, monkeypatch, capsys):
    from benchmarks_torch import common, run
    monkeypatch.setattr(common, "ART_DIR", str(tmp_path))
    results = run.main(["--quick", "--only", "roofline_table", "--device",
                        "cpu"])
    res = results["roofline_table"]
    assert (res["n_cells"], res["n_ok"]) == (1, 1)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "dryrun_quick", "roofline_table.json"]
    assert [p.name for p in (tmp_path / "dryrun_quick").iterdir()] == [
        "smollm-135m__train_4k__card.json"]
    assert "1/1 ok" in capsys.readouterr().out


# ----------------------------------------------------- the meta repairs ----
def test_lr_at_runs_on_a_meta_step_with_no_host_read():
    """The schedule's table entry is read on the step's device
    (``index_select``), so a ``meta`` step gives a ``meta`` 0-d float32
    where ``table[idx]`` would call ``.item()``."""
    oc = tadamw.OptConfig(lr=1e-3, warmup_steps=4, total_steps=40)
    lr = tadamw.lr_at(oc, torch.empty((), dtype=torch.int32, device="meta"))
    assert lr.device.type == "meta" and lr.shape == () and \
        lr.dtype == torch.float32
    for s in (0, 3, 4, 17, 40, 45):
        got = tadamw.lr_at(oc, torch.tensor(s, dtype=torch.int32))
        assert got.shape == () and got.dtype == torch.float32


def test_check_positions_passes_over_meta_and_still_raises_on_cpu():
    tattn.check_positions(torch.empty(4, dtype=torch.int32, device="meta"), 8)
    tattn.check_positions(torch.tensor([0, 7]), 8)
    with pytest.raises(IndexError, match="outside"):
        tattn.check_positions(torch.tensor([0, 8]), 8)
    with pytest.raises(IndexError, match="outside"):
        tattn.check_positions(-1, 8)


def test_abstract_state_gives_trainable_meta_leaves_on_request():
    cfg = tconfigs.reduced_config("smollm-135m")
    plain = tstep.abstract_state(cfg)
    assert isinstance(plain["params"], dict)
    assert not any(p.requires_grad for _, p in tree_leaves(plain["params"]))
    train = tstep.abstract_state(cfg, trainable=True)
    params = list(train["params"].parameters())
    assert params and all(p.requires_grad and p.device.type == "meta"
                          for p in params)
    assert _port_leaves(train["opt"]) == _port_leaves(plain["opt"])
