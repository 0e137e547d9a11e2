"""Dry-run: count every (arch × shape × mesh) cell on ``meta`` tensors
(port of ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell for 512 placeholder devices
and parses the HLO. The port has no compiler: each cell's step —
``train.step.make_train_step``, ``serve.engine.make_prefill_step`` or
``make_serve_step``, the functions the port trains and serves with — runs
once on ``meta`` tensors (shapes and dtypes, no memory) under
``roofline.op_costs.OpCosts``, which charges every dispatched op and tracks
the live storages. Three meshes:

- ``card``: one H100, the whole step on plain ``meta`` tensors;
- ``single`` and ``multipod``: the reference's production meshes, (16, 16)
  over ("data", "model") and (2, 16, 16) over ("pod", "data", "model")
  (``launch.mesh.make_production_mesh``). This process is rank 0 of a
  ``"fake"`` process group of 512 ranks (``launch.mesh.
  fake_process_group``; started here when none is initialized, and torn
  down only if started here), and the step runs on ``meta`` DTensors
  placed by the cell's rules (``launch.inputs.input_specs(mesh=)``): what
  is counted is rank 0's share — its local ops, its live local shards,
  and the collectives DTensor and the models' regions issue
  (``roofline.collectives``). As in the reference's dry-run, ``use_flash``
  is off on these meshes.

For each cell it records

- the peak of live storages per chip — the counterpart of
  ``compiled.memory_analysis()``; ``fits_hbm`` against the H100's 80 GB,
- the step's FLOPs, transcendentals and bytes per chip (``bytes_major``:
  each hand-written kernel call at its own bytes; ``bytes``: the eager
  upper bound), its matmul FLOPs, and the kernel calls it would launch,
- the collectives per chip: count, operand and wire bytes (the reference's
  ring model), by op,
- the three roofline terms with the H100's constants (``roofline.terms``;
  the collective term at NVLink's 450 GB/s, a lower bound: a 16-wide axis
  spans two 8-GPU nodes, whose link is slower — ``COLLECTIVE_NOTE``),

in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``, with the JAX
cell's keys (``fits_hbm`` in place of ``fits_16GiB``; the XLA-only figures
``None``). The sLSTM recurrence (``models/xlstm.py``) is a loop of one
step a token (``kernels.ops.token_loop``); on ``meta`` one step is run and
charged as all of them (``OpCosts.token_loop``, ``while_trips``), as
``hlo_costs`` scales a while body.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k \\
        [--multi-pod | --card]
    python -m repro_torch.launch.dryrun --all [--single-pod-only |
        --multi-pod-only | --card-only] [--skip-existing]
        [--out artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.launch import inputs as inp
from repro_torch.launch import mesh as lmesh
from repro_torch.models import api, layers
from repro_torch.models.common import torch_dtype
from repro_torch.optim import adamw
from repro_torch.roofline import collectives as coll
from repro_torch.roofline import hw
from repro_torch.roofline import terms as rt
from repro_torch.roofline.op_costs import OpCosts, storages
from repro_torch.serve import engine as serve_engine
from repro_torch.sharding import rules as shr
from repro_torch.train import step as train_step_mod

MESH = "card"
MESHES = (MESH,) + tuple(lmesh.PRODUCTION_MESHES)
OUT_DIR = "artifacts/dryrun_torch"
COLLECTIVE_NOTE = (
    "collective term at NVLink's 450 GB/s a link: a lower bound, since a "
    "16-wide mesh axis spans two 8-GPU NVLink nodes and its ring crosses "
    "the slower link between them")


def _check_mesh(mesh_name: str) -> None:
    if mesh_name not in MESHES:
        raise ValueError(f"mesh {mesh_name!r}: one of {MESHES}")


def build_cell(arch: str, shape_name: str,
               cfg_overrides: dict | None = None,
               shape_overrides: dict | None = None, mesh=None):
    """(step, args, spec): one cell's step function and its ``meta``
    arguments (``inputs.input_specs``; on ``mesh``, DTensors)."""
    spec = inp.input_specs(arch, shape_name, cfg_overrides, shape_overrides,
                           mesh=mesh)
    cfg, shape = spec["cfg"], spec["shape"]
    if shape.kind == "train":
        step = train_step_mod.make_train_step(
            cfg, adamw.OptConfig(moment_dtype=spec["moment_dtype"]),
            n_microbatches=spec["n_microbatches"],
            accum_dtype=torch_dtype(spec["accum_dtype"]))
        args = (spec["state"], spec["batch"])
    elif shape.kind == "prefill":
        step = serve_engine.make_prefill_step(cfg, shape.seq_len)
        args = (spec["params"], spec["batch"])
    else:
        step = serve_engine.make_serve_step(cfg)
        args = (spec["params"], spec["tokens"], spec["pos"], spec["cache"])
    return step, args, spec


def count_step(step, args, train: bool):
    """(OpCosts, memory dict): ``step(*args)`` run once under the count,
    with grad for a train step; the memory dict in
    ``compiled.memory_analysis()``'s terms (arguments, outputs, the
    outputs that alias an argument — the state the step updates in place —
    and the temporaries: peak = arguments + outputs + temporaries -
    aliased). Every count is a process's first step, whatever the process
    counted before: the constants made once a device and cached (the RoPE
    frequencies, the learning-rate schedule's table) are made inside it."""
    layers._rope_freqs.cache_clear()
    adamw._decay_table_on.cache_clear()
    inputs = storages(*args)
    with OpCosts() as oc:
        oc.track(*args)
        with torch.set_grad_enabled(train):
            out = step(*args)
    outs = storages(out)
    arg_b = sum(inputs.values())
    out_b = sum(n for k, n in outs.items() if k not in inputs)
    alias_b = sum(n for k, n in outs.items() if k in inputs)
    peak = oc.peak_bytes
    return oc, {"argument_bytes": arg_b, "output_bytes": out_b,
                "temp_bytes": peak - arg_b - out_b + alias_b,
                "alias_bytes": alias_b, "peak_bytes_per_chip": peak,
                "fits_hbm": bool(peak < hw.HBM_PER_CHIP)}


@contextlib.contextmanager
def _sharded(rules: dict, mesh):
    """The sharded step's context: the cell's rules on ``mesh`` (the
    models' ``shard`` annotations read them), and plain tensors made inside
    the step (positions, masks: the same on every rank) taken as
    replicated where they meet DTensors."""
    with shr.use_rules(rules, mesh), implicit_replication():
        yield


def analyze_cell(arch: str, shape_name: str, mesh_name: str = MESH,
                 cfg_overrides: dict | None = None,
                 shape_overrides: dict | None = None, mesh=None) -> dict:
    """Count one cell on ``meta`` and extract every roofline input
    (``shape_overrides``: the shape's cuts, recorded under ``overrides``).
    ``mesh_name`` ``"single"`` or ``"multipod"`` counts rank 0's share on
    that production mesh under a fake process group of 512 ranks (started
    here unless one is initialized); ``mesh`` gives another ``DeviceMesh``
    of the initialized group in its place (a test's)."""
    _check_mesh(mesh_name)
    if mesh_name == MESH and mesh is None:
        return _analyze(arch, shape_name, mesh_name, None, cfg_overrides,
                        shape_overrides)
    cfg_overrides = {"use_flash": False, **(cfg_overrides or {})}
    with lmesh.fake_process_group():
        if mesh is None:
            mesh = lmesh.make_production_mesh(
                multi_pod=mesh_name == "multipod")
        return _analyze(arch, shape_name, mesh_name, mesh, cfg_overrides,
                        shape_overrides)


def _analyze(arch, shape_name, mesh_name, mesh, cfg_overrides,
             shape_overrides) -> dict:
    step, args, spec = build_cell(arch, shape_name, cfg_overrides,
                                  shape_overrides, mesh=mesh)
    cfg, shape = spec["cfg"], spec["shape"]
    sharded = (contextlib.nullcontext() if mesh is None else
               _sharded(spec["rules"], mesh))
    t0 = time.perf_counter()
    with sharded:
        oc, memory = count_step(step, args, shape.kind == "train")
    t_count = time.perf_counter() - t0
    costs = oc.rollup()
    chips = 1 if mesh is None else mesh.size()

    n_params = api.n_params(cfg)
    mf = rt.model_flops(cfg, n_params, shape.kind, shape.seq_len,
                        shape.global_batch)
    af = rt.attn_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
    terms = rt.RooflineTerms(
        flops_per_chip=costs.flops,
        hbm_bytes_per_chip=costs.bytes_major,
        wire_bytes_per_chip=costs.coll_wire,
        chips=chips,
        model_flops_global=mf,
        attn_flops_global=af,
    )
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mesh_dims": {MESH: 1} if mesh is None else lmesh.mesh_dims(mesh),
        "chips": chips,
        "kind": shape.kind,
        "n_params": n_params,
        "n_params_active": rt.active_params(cfg, n_params),
        "memory": memory,
        "cost": {
            "parsed_flops_per_chip": costs.flops,
            "parsed_bytes_per_chip": costs.bytes_major,
            "parsed_bytes_upper_bound": costs.bytes,
            "parsed_transcendentals": costs.transcendentals,
            "matmul_flops": oc.matmul_flops,
            # no XLA here: no flat cost analysis, no unrolled crosscheck
            "xla_flat_flops": None,
            "xla_flat_bytes": None,
            "crosscheck_unrolled_global_flops": None,
            "while_trips": costs.while_trips,
        },
        "collectives": {
            "count": costs.coll_count,
            "operand_bytes": costs.coll_operand,
            "wire_bytes": costs.coll_wire,
            "by_op": costs.coll_by_op,
            "flat_structure": coll.summarize(oc.collectives),
        },
        "kernels": {"calls": dict(oc.kernel_calls),
                    "plain_backwards": oc.plain_backwards},
        "roofline": terms.to_dict() | (
            {} if mesh is None else {"collective_note": COLLECTIVE_NOTE}),
        "timing": {"lower_s": None, "compile_s": None, "count_s": t_count},
        "overrides": {"cfg": cfg_overrides or {}, "rules": {},
                      "shape": shape_overrides or {}},
    }


def run_cells(cells, out_dir: str = OUT_DIR, skip_existing: bool = False,
              cfg_overrides: dict | None = None,
              shape_overrides: dict | None = None) -> list[dict]:
    for _, _, mesh_name in cells:
        _check_mesh(mesh_name)
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch, shape_name, mesh_name in cells:
        tag = f"{arch}__{shape_name}__{mesh_name}"
        path = os.path.join(out_dir, tag + ".json")
        if skip_existing and os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
            print(f"[skip] {tag}")
            continue
        try:
            res = analyze_cell(arch, shape_name, mesh_name, cfg_overrides,
                               shape_overrides)
            r = res["roofline"]
            print(f"[ok] {tag}: flops={r['flops_per_chip']:.3e} "
                  f"bytes={r['hbm_bytes_per_chip']:.3e} "
                  f"wire={r['wire_bytes_per_chip']:.3e} "
                  f"peak={res['memory']['peak_bytes_per_chip'] / 1e9:.2f}GB "
                  f"bottleneck={r['bottleneck']} "
                  f"(count {res['timing']['count_s']:.1f}s)")
        except Exception as e:
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
            if not isinstance(e, ValueError):
                traceback.print_exc()
            res = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "error": str(e)}
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        results.append(res)
    return results


def all_cells(mesh_names=("single", "multipod")):
    cells = []
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        for shape_name, shape in configs.SHAPES.items():
            ok, _ = configs.applicable(cfg, shape)
            if not ok:
                continue
            for mesh_name in mesh_names:
                cells.append((arch, shape_name, mesh_name))
    return cells


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, choices=list(configs.ARCHS))
    p.add_argument("--shape", default=None, choices=list(configs.SHAPES))
    p.add_argument("--all", action="store_true",
                   help="every cell on both production meshes")
    p.add_argument("--multi-pod", action="store_true",
                   help="use the 2x16x16 multi-pod mesh for --arch/--shape")
    p.add_argument("--card", action="store_true",
                   help="count --arch/--shape on one card")
    p.add_argument("--single-pod-only", action="store_true")
    p.add_argument("--multi-pod-only", action="store_true")
    p.add_argument("--card-only", action="store_true",
                   help="--all on one card (the one-card sweep)")
    p.add_argument("--out", default=OUT_DIR)
    p.add_argument("--skip-existing", action="store_true")
    args = p.parse_args(argv)

    if args.all:
        names = ("single", "multipod")
        if args.single_pod_only:
            names = ("single",)
        if args.multi_pod_only:
            names = ("multipod",)
        if args.card_only:
            names = (MESH,)
        cells = all_cells(names)
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape, or --all")
        name = ("multipod" if args.multi_pod else
                MESH if args.card else "single")
        cells = [(args.arch, args.shape, name)]
    results = run_cells(cells, args.out, args.skip_existing)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n{len(results) - n_fail}/{len(results)} cells OK")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
