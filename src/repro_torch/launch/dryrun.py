"""One-card dry-run: count every (arch × shape) cell on ``meta`` tensors
(port of ``repro.launch.dryrun``'s single-card half).

The JAX package lowers and compiles each cell for 512 placeholder devices
and parses the HLO. The port has one card and no compiler: each cell's step
— ``train.step.make_train_step``, ``serve.engine.make_prefill_step`` or
``make_serve_step``, the functions the port trains and serves with — runs
once on ``meta`` tensors (shapes and dtypes, no memory) under
``roofline.op_costs.OpCosts``, which charges every dispatched op and tracks
the live storages. For each cell it records

- the peak of live storages — the counterpart of
  ``compiled.memory_analysis()``; ``fits_hbm`` against the H100's 80 GB,
- the step's FLOPs, transcendentals and bytes (``bytes_major``: each
  hand-written kernel call at its own bytes; ``bytes``: the eager upper
  bound), its matmul FLOPs, and the kernel calls it would launch,
- the three roofline terms with the H100's constants (``roofline.terms``);
  the collective term is 0 on one card,

in ``artifacts/dryrun_torch/<arch>__<shape>__card.json``, with the JAX
cell's keys (``fits_hbm`` in place of ``fits_16GiB``; the XLA-only figures
``None``).

The mesh is ``"card"`` (one chip). ``--multi-pod`` and the ``multipod``
mesh are the multi-card row of ROADMAP.md (A14b) and refuse. A cell whose
step the ``meta`` run cannot count in reasonable time is an ``error`` cell
with its reason: the sLSTM recurrence (``models/xlstm.py``) is a Python loop of one
step a token, so xlstm's train and prefill cells would run hundreds of
thousands of steps (``TOKEN_LOOP_LIMIT``).

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--skip-existing]
        [--out artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import inputs as inp
from repro_torch.models import api
from repro_torch.models.common import torch_dtype
from repro_torch.optim import adamw
from repro_torch.roofline import hw
from repro_torch.roofline import terms as rt
from repro_torch.roofline.op_costs import OpCosts, storages
from repro_torch.serve import engine as serve_engine
from repro_torch.train import step as train_step_mod

MESH = "card"
CHIPS = 1
OUT_DIR = "artifacts/dryrun_torch"
# the most sLSTM token steps a count takes on (each ~35 dispatched ops);
# xlstm-1.3b's train_4k needs 73,728 and its prefill_32k 196,608
TOKEN_LOOP_LIMIT = 16_384


def _refuse_mesh(mesh_name: str) -> None:
    if mesh_name != MESH:
        raise NotImplementedError(
            f"mesh {mesh_name!r}: multi-card meshes are {inp.MULTI_CARD}; "
            f"the port's dry-run runs on one card (mesh {MESH!r})")


def token_loop_steps(cfg, shape) -> int:
    """Python steps of the sLSTM token loop in one step of the cell (the
    train step runs the recurrence forward, again under remat, and
    backward)."""
    if cfg.family != "xlstm" or shape.kind == "decode":
        return 0
    n_slstm = cfg.n_layers // cfg.slstm_every
    return shape.seq_len * n_slstm * (3 if shape.kind == "train" else 1)


def build_cell(arch: str, shape_name: str,
               cfg_overrides: dict | None = None,
               shape_overrides: dict | None = None):
    """(step, args, spec): one cell's step function and its ``meta``
    arguments (``inputs.input_specs``)."""
    spec = inp.input_specs(arch, shape_name, cfg_overrides, shape_overrides)
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
    aliased)."""
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


def analyze_cell(arch: str, shape_name: str, mesh_name: str = MESH,
                 cfg_overrides: dict | None = None,
                 shape_overrides: dict | None = None) -> dict:
    """Count one cell on ``meta`` and extract every roofline input
    (``shape_overrides``: the shape's cuts, recorded under
    ``overrides``)."""
    _refuse_mesh(mesh_name)
    step, args, spec = build_cell(arch, shape_name, cfg_overrides,
                                  shape_overrides)
    cfg, shape = spec["cfg"], spec["shape"]
    steps = token_loop_steps(cfg, shape)
    if steps > TOKEN_LOOP_LIMIT:
        raise ValueError(
            f"not counted: the sLSTM token loop (models/xlstm.py) would run "
            f"{steps:,} Python steps on meta (seq_len {shape.seq_len:,} x "
            f"{cfg.n_layers // cfg.slstm_every} sLSTM layers"
            f"{' x 3 (forward, remat, backward)' if shape.kind == 'train' else ''}"
            f"), over the dry-run's limit of {TOKEN_LOOP_LIMIT:,}")
    t0 = time.perf_counter()
    oc, memory = count_step(step, args, shape.kind == "train")
    t_count = time.perf_counter() - t0
    costs = oc.rollup()

    n_params = api.n_params(cfg)
    mf = rt.model_flops(cfg, n_params, shape.kind, shape.seq_len,
                        shape.global_batch)
    af = rt.attn_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
    terms = rt.RooflineTerms(
        flops_per_chip=costs.flops,
        hbm_bytes_per_chip=costs.bytes_major,
        wire_bytes_per_chip=costs.coll_wire,
        chips=CHIPS,
        model_flops_global=mf,
        attn_flops_global=af,
    )
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mesh_dims": {MESH: CHIPS},
        "chips": CHIPS,
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
            "flat_structure": {"by_op": {}, "count": 0, "operand_bytes": 0,
                               "wire_bytes": 0},
        },
        "kernels": {"calls": dict(oc.kernel_calls),
                    "plain_backwards": oc.plain_backwards},
        "roofline": terms.to_dict(),
        "timing": {"lower_s": None, "compile_s": None, "count_s": t_count},
        "overrides": {"cfg": cfg_overrides or {}, "rules": {},
                      "shape": shape_overrides or {}},
    }


def run_cells(cells, out_dir: str = OUT_DIR, skip_existing: bool = False,
              cfg_overrides: dict | None = None,
              shape_overrides: dict | None = None) -> list[dict]:
    for _, _, mesh_name in cells:
        _refuse_mesh(mesh_name)
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


def all_cells(mesh_names=(MESH,)):
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
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true",
                   help="the multi-pod mesh (the multi-card row, A14b: "
                        "refused)")
    p.add_argument("--out", default=OUT_DIR)
    p.add_argument("--skip-existing", action="store_true")
    args = p.parse_args(argv)

    if args.multi_pod:
        _refuse_mesh("multipod")
    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, MESH)]
    results = run_cells(cells, args.out, args.skip_existing)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n{len(results) - n_fail}/{len(results)} cells OK")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
