"""Benchmark aggregator of the port: ``PYTHONPATH=src python -m benchmarks_torch.run``.

Runs the paper's experiments on the port (on the GPU unless ``--device
cpu``): Table II's sequential baseline, Fig 5's analytic profile, Fig 7's
speedup against nTasks on 11x11 Hex (with one point at the paper's full
1,048,576-playout budget) and on 15x15 Gomoku, Fig 9's traced dispatch fit,
the virtual-loss ablation and root-parallel scaling. Writes one JSON per
job to ``artifacts/bench_torch/`` and, when the run includes fig7, the
root-level ``BENCH_mcts_torch.json`` summary stamped with the card's name
and power limit. ``--quick`` shrinks every job to a small board (a check
that the jobs run, e.g. on the CPU).

Budgets on the card: 65,536 playouts a sweep point at 256 lanes, nTasks
from 16 up (a point with nTasks < W runs ``playouts / nTasks`` sync
iterations, so nTasks = 1 at the paper's budget would take hours), each
point the best of 3 searches taken in turns across the sweep; the
sequential baseline at 2,048 playouts (1,024 for Gomoku), timed in the
same turns.

``tpfifo`` is LM serving's grain sweep: TPFIFO against lockstep on a
Poisson trace (``benchmarks_torch.tpfifo``). The game-serving jobs are the
JAX aggregator's, each in its card form (``CARD`` of its module: 11x11 for
both classes at 256 lanes): ``serve_games`` (TPFIFO against one_per_core,
pipelined against blocking), ``serve_chaos`` (goodput across fault rates)
and ``selfplay`` (warm against cold moves); ``kernels_micro`` holds every
kernel against its plain version at the JAX twin's shapes and times it.
``roofline_table`` renders the one-card dry-run's cells
(``artifacts/dryrun_torch/``, written by ``python -m
repro_torch.launch.dryrun --all``); with ``--quick`` it first dry-runs one
reduced cell into ``dryrun_quick/`` beside the job's JSON and renders that.
``render_experiments`` renders the sharded dry-run's summary, its
single-pod table and their reading from the same artifacts (the reference
fills them into its write-up; here they are the job's JSON).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
import traceback

from repro_torch.configs.hex_paper import PAPER, TASK_SWEEP

NOT_PORTED: dict[str, str] = {}

# the card's configuration: the paper's 11x11 Hex at 256 lanes (the width
# of every Hex phase of chip_smoke.py), Cp = 1
HEX = dict(board_size=11, n_workers=256)
SWEEP_PLAYOUTS = 65_536
HEX_SWEEP = tuple(t for t in TASK_SWEEP if t >= 16)
GOMOKU_SWEEP = (64, 256, 1024, 4096)
SEQ_PLAYOUTS = 2048
# --quick's dry-run cell: smollm-135m's train_4k at tests/test_dryrun.py's
# reduced widths
QUICK_CELL = ("smollm-135m", "train_4k")
QUICK_OVERRIDES = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                       d_ff=512, vocab=4096)


def roofline_job(quick: bool) -> dict:
    from benchmarks_torch import common, roofline_table
    if not quick:
        return roofline_table.run()
    from repro_torch.launch import dryrun
    out = os.path.join(common.ART_DIR, "dryrun_quick")
    dryrun.run_cells([(*QUICK_CELL, dryrun.MESH)], out,
                     cfg_overrides=QUICK_OVERRIDES)
    return roofline_table.run(out)


def jobs_for(quick: bool, device) -> dict:
    from benchmarks_torch import (ablate_vloss, fig5_cilkview, fig7_speedup,
                                  kernels_micro, render_experiments,
                                  root_parallel, selfplay, serve_chaos,
                                  serve_games, table2_sequential, tpfifo)

    dev = dict(device=device)
    if quick:
        hex_kw = dict(board_size=5, n_workers=8, n_playouts=256,
                      task_sweep=(4, 16, 64), repeats=1, seq_playouts=64)
        return {
            "table2_sequential": lambda: table2_sequential.run(
                n_playouts=64, board_size=5, **dev),
            "fig5_cilkview": lambda: fig5_cilkview.run(),
            "fig7_speedup": lambda: fig7_speedup.run(
                metrics=True, **hex_kw, **dev),
            "fig7_paper": lambda: fig7_speedup.run(
                **{**hex_kw, "n_playouts": 512, "task_sweep": (64,)},
                schedulers=("fifo",), **dev),
            "fig7_gomoku": lambda: fig7_speedup.run(
                game="gomoku", **{**hex_kw, "task_sweep": (16, 64)}, **dev),
            "fig9_mapping": None,     # on fig7_speedup's result, below
            "ablate_vloss": lambda: ablate_vloss.run(
                n_playouts=256, n_workers=8, board_size=5, **dev),
            "root_parallel": lambda: root_parallel.run(
                n_playouts=64, repeats=1, **dev),
            "root_parallel_wide": lambda: root_parallel.run(
                n_playouts=128, n_workers=8, n_tasks=16, repeats=1, **dev),
            "tpfifo": lambda: tpfifo.run(smoke=True, **dev),
            "serve_games": lambda: serve_games.run(smoke=True, **dev),
            "serve_chaos": lambda: serve_chaos.run(smoke=True, **dev),
            "selfplay": lambda: selfplay.run(smoke=True, **dev),
            "kernels_micro": lambda: kernels_micro.run(
                flash_shapes=((1, 2, 1, 32, 16),), uct_shapes=((16, 32),),
                hex_shapes=((5, 8),), gomoku_shapes=((5, 4),),
                rmsnorm_shapes=((16, 64),), iters=2, **dev),
            "roofline_table": lambda: roofline_job(quick=True),
            "render_experiments": lambda: render_experiments.run(),
        }
    hex_kw = dict(**HEX, n_playouts=SWEEP_PLAYOUTS, repeats=3,
                  seq_playouts=SEQ_PLAYOUTS)
    return {
        "table2_sequential": lambda: table2_sequential.run(
            n_playouts=4096, **dev),
        "fig5_cilkview": lambda: fig5_cilkview.run(),
        "fig7_speedup": lambda: fig7_speedup.run(
            task_sweep=HEX_SWEEP, metrics=True, **hex_kw, **dev),
        # the paper's own point: 1,048,576 playouts, fifo, 4,096 tasks
        "fig7_paper": lambda: fig7_speedup.run(
            **{**hex_kw, "n_playouts": PAPER.n_playouts, "repeats": 1},
            task_sweep=(PAPER.n_tasks,), schedulers=("fifo",), **dev),
        "fig7_gomoku": lambda: fig7_speedup.run(
            game="gomoku", **{**hex_kw, "board_size": 15,
                              "seq_playouts": 1024},
            task_sweep=GOMOKU_SWEEP, metrics=True, **dev),
        "fig9_mapping": None,
        "ablate_vloss": lambda: ablate_vloss.run(
            n_playouts=SWEEP_PLAYOUTS, **HEX, n_tasks=1024,
            tree_cap=1 << 18, **dev),
        # the JAX twin's narrow members (W = 1 on 5x5), and the card's
        # forest members (W = 32 on 11x11, chip_smoke.py's hex_forest)
        "root_parallel": lambda: root_parallel.run(
            n_playouts=1024, repeats=3, **dev),
        "root_parallel_wide": lambda: root_parallel.run(
            n_playouts=8192, n_workers=32, board_size=11, n_tasks=128,
            tree_cap=1 << 16, repeats=3, **dev),
        "tpfifo": lambda: tpfifo.run(**dev),
        "serve_games": lambda: serve_games.run(**serve_games.CARD, **dev),
        "serve_chaos": lambda: serve_chaos.run(**serve_chaos.CARD, **dev),
        "selfplay": lambda: selfplay.run(**selfplay.CARD, **dev),
        "kernels_micro": lambda: kernels_micro.run(**dev),
        "roofline_table": lambda: roofline_job(quick=False),
        "render_experiments": lambda: render_experiments.run(),
    }


def fig9_job(results: dict, quick: bool, device):
    from benchmarks_torch import fig9_mapping

    fig7 = results.get("fig7_speedup")
    if fig7 is None:
        raise RuntimeError("fig9_mapping reads fig7_speedup's fifo curve: "
                           "run it together with fig7_speedup")
    b = int(fig7["board"].split("x")[0])
    return fig9_mapping.run(
        n_playouts=fig7["n_playouts"], n_workers=fig7["n_workers"],
        board_size=b, measured=fig7,
        profile_tasks=(4, 16, 64) if quick else (256, 1024, 4096, 16384),
        device=device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--only", default=None,
                   help="comma-separated subset, e.g. table2,fig7")
    p.add_argument("--quick", action="store_true",
                   help="small boards and budgets (a check that every job "
                        "runs)")
    p.add_argument("--device", default=None,
                   help="torch device; default: cuda")
    args = p.parse_args(argv)

    from benchmarks_torch.common import device_stamp, save_result

    jobs = jobs_for(args.quick, args.device)
    if args.only:
        keep = [k.strip() for k in args.only.split(",") if k.strip()]
        refused = [k for k in keep if k in NOT_PORTED]
        if refused:
            raise NotImplementedError(", ".join(
                f"{k}: not ported yet ({NOT_PORTED[k]} of ROADMAP.md)"
                for k in refused))
        jobs = {k: v for k, v in jobs.items() if any(s in k for s in keep)}

    failures = []
    results: dict[str, dict] = {}
    for name, job in jobs.items():
        t0 = time.perf_counter()
        print(f"=== {name} ===", flush=True)
        try:
            res = (fig9_job(results, args.quick, args.device)
                   if name == "fig9_mapping" else job())
            results[name] = res
            path = save_result(name, res)
            print(json.dumps(_summ(name, res), indent=1))
            print(f"[{name}] ok in {time.perf_counter()-t0:.1f}s -> {path}\n",
                  flush=True)
        except Exception as e:
            failures.append(name)
            print(f"[{name}] FAILED: {type(e).__name__}: {e}")
            traceback.print_exc()
    traj = write_mcts_trajectory(results, device_stamp(args.device))
    if traj:
        print(f"perf summary -> {traj}")
    print("benchmarks complete;",
          f"{len(jobs) - len(failures)}/{len(jobs)} ok",
          ("FAILED: " + ", ".join(failures)) if failures else "")
    if failures:
        raise SystemExit(1)
    return results


def best_of(res: dict) -> tuple[float, dict]:
    rate, point = 0.0, {}
    for sched, pts in res["curves"].items():
        for n_tasks, p in pts.items():
            if p["playouts_per_s"] > rate:
                rate = p["playouts_per_s"]
                point = {"scheduler": sched, "n_tasks": int(n_tasks),
                         "speedup": p["speedup"]}
    return rate, point


def write_mcts_trajectory(results: dict, device) -> str | None:
    """Write the root-level BENCH_mcts_torch.json from a run containing
    fig7: the search's best playouts/s and the nTasks it came at, the best
    speedup over the sequential searcher, the sequential rate, and the
    card it was measured on; with the serving jobs, the JAX aggregator's
    ``serving``, ``pipeline``, ``selfplay`` and ``chaos`` keys, and with
    ``kernels_micro`` the playout pipeline's ``playout_eval_per_s``, each
    beside the card it was measured on."""
    fig7 = results.get("fig7_speedup")
    if not fig7:
        return None
    import torch

    best_rate, best_point = best_of(fig7)
    seq = fig7["sequential_playouts_per_s"]
    payload = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": _git_sha(),
        "device": device,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "board": fig7["board"],
        "n_workers": fig7["n_workers"],
        "n_playouts": fig7["n_playouts"],
        "timing": fig7["timing"],
        "sequential_playouts": fig7["sequential_playouts"],
        "sequential_playouts_per_s": seq,
        "best_playouts_per_s": best_rate,
        "best_point": best_point,
        "best_speedup_vs_sequential": best_rate / max(seq, 1e-9),
    }
    games = {}
    for name, res in results.items():
        if name.startswith("fig7") and name != "fig7_paper":
            rate, point = best_of(res)
            games[res.get("game", "hex")] = {
                "board": res["board"],
                "sequential_playouts_per_s": res[
                    "sequential_playouts_per_s"],
                "best_playouts_per_s": rate,
                "best_point": point,
            }
    payload["games"] = games
    if "fig7_paper" in results:
        r = results["fig7_paper"]
        (n_tasks, pt), = r["curves"]["fifo"].items()
        payload["paper_point"] = {"n_playouts": r["n_playouts"],
                                  "scheduler": "fifo",
                                  "n_tasks": int(n_tasks), **pt}
    if "table2_sequential" in results:
        t = results["table2_sequential"]
        payload["table2"] = {k: t[k] for k in (
            "n_playouts", "playouts_per_s", "per_playout_us",
            "extrapolated_paper_budget_s", "paper_xeon_s", "paper_phi_s")}
    if "fig9_mapping" in results:
        prof = results["fig9_mapping"]["dispatch_profile"]
        payload["dispatch_profile"] = {k: prof[k] for k in (
            "identifiable", "t_round_s", "t_sync_iter_s", "t_iter_s",
            "fit_rms_rel", "n_spans")}
    if "ablate_vloss" in results:
        payload["vloss"] = {r: {"tree_nodes": v["tree_nodes"],
                                "playouts_per_s": v["playouts_per_s"]}
                            for r, v in results["ablate_vloss"][
                                "results"].items()}
    for name in ("root_parallel", "root_parallel_wide"):
        if name in results:
            res = results[name]
            payload[name] = {
                "n_workers": res["config"]["n_workers"],
                "board_size": res["config"]["board_size"],
                "single_tree_playouts_per_s": res[
                    "single_tree_playouts_per_s"],
                "aggregate_speedup": {e: p["aggregate_speedup"]
                                      for e, p in res["ensemble"].items()}}
    if "serve_games" in results:
        # mixed Hex + Gomoku Poisson serving: move latency against
        # one_per_core, served playouts/s, the zero-build ledger; pipelined
        # against blocking retirement on the same trace
        res = results["serve_games"]
        payload["serving"] = {**res["serving"], "device": res["device"]}
        payload["pipeline"] = {**res["pipeline"], "device": res["device"]}
    if "selfplay" in results:
        # cross-move tree reuse: warm against cold move latency
        res = results["selfplay"]
        payload["selfplay"] = {**res["selfplay"], "device": res["device"]}
    if "serve_chaos" in results:
        # goodput and latency against the injected fault rate
        res = results["serve_chaos"]
        payload["chaos"] = {**res["chaos"], "device": res["device"]}
    km = results.get("kernels_micro")
    if km:
        # the fused playout's boards/s per (board, W) case and the best
        cases = {k: v["playout_eval_per_s"]
                 for k, v in km["hex_winner"].items()}
        payload["playout_eval_per_s"] = max(cases.values())
        payload["playout_eval_per_s_by_case"] = cases
        payload["playout_eval_device"] = km["device"]
    path = os.path.join(os.path.dirname(__file__), "..",
                        "BENCH_mcts_torch.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return os.path.abspath(path)


def _git_sha() -> str | None:
    """Commit the summary describes (None outside a git checkout — the
    summary must never make the benchmark run fail)."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)), timeout=10,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _summ(name: str, res: dict) -> dict:
    """Console-sized digest per benchmark."""
    if name == "table2_sequential":
        return {k: res[k] for k in ("n_playouts", "time_s", "per_playout_us",
                                    "extrapolated_paper_budget_s")}
    if name == "fig5_cilkview":
        b = res["speedup_bounds"]
        i61 = res["core_counts"].index(61)
        return {"bound_61c_16384t": b["16384"][i61],
                "bound_61c_64t": b["64"][i61]}
    if name.startswith("fig7"):
        return {s: {t: round(p["speedup"], 2) for t, p in pts.items()}
                for s, pts in res["curves"].items()}
    if name.startswith("root_parallel"):
        return {f"E={e}": round(p["aggregate_speedup"], 2)
                for e, p in res["ensemble"].items()}
    if name == "fig9_mapping":
        prof = res["dispatch_profile"]
        return {"identifiable": prof["identifiable"],
                "t_round_s": prof["t_round_s"],
                "t_sync_iter_s": prof["t_sync_iter_s"],
                "overlay": {t: {k: round(v, 2) for k, v in o.items()}
                            for t, o in res["overlay"].items()}}
    if name == "tpfifo":
        return {"lockstep_tok_s": round(res["lockstep"]["throughput_tok_s"], 1),
                "best_grain": res["best_grain"],
                "best_speedup": round(res["best_speedup"], 2)}
    if name == "ablate_vloss":
        return {r: {"tree_nodes": v["tree_nodes"],
                    "playouts_per_s": round(v["playouts_per_s"])}
                for r, v in res["results"].items()}
    if name == "serve_games":
        s = res["serving"]
        return {"playouts_per_s": round(s["playouts_per_s"]),
                "move_latency_ms": {"p50": round(
                    s["move_latency_p50_s"] * 1e3),
                    "p95": round(s["move_latency_p95_s"] * 1e3)},
                "p50_vs_one_per_core": round(s["p50_vs_one_per_core"], 2),
                "p95_vs_one_per_core": round(s["p95_vs_one_per_core"], 2),
                "blocking_p50_vs_one_per_core": round(
                    s["blocking_p50_vs_one_per_core"], 2),
                "preemptions": s["preemptions"],
                "recompiles": s["recompiles"],
                "pipeline_speedup": round(res["pipeline"]["speedup"], 2)}
    if name == "serve_chaos":
        c = res["chaos"]
        return {"fault_rates": c["fault_rates"],
                "goodput_playouts_per_s": [round(g) for g in
                                           c["goodput_playouts_per_s"]],
                "latency_p95_ms": [round(v * 1e3) for v in
                                   c["latency_p95_s"]],
                "retries": c["retries"], "quarantined": c["quarantined"],
                "goodput_at_max_rate_vs_clean": round(
                    c["goodput_at_max_rate_vs_clean"], 2),
                "recompiles": c["recompiles"]}
    if name == "selfplay":
        s = res["selfplay"]
        return {"warm_p50_ms": round(s["warm_move_p50_s"] * 1e3),
                "cold_p50_ms": round(s["cold_move_p50_s"] * 1e3),
                "p50_speedup": round(s["p50_speedup_warm_vs_cold"], 2),
                "mean_retained_fraction": round(
                    s["mean_retained_fraction"], 3),
                "recompiles": s["recompiles"]}
    if name == "kernels_micro":
        return {k: list(v) for k, v in res.items()
                if isinstance(v, dict) and k != "device"}
    if name in ("roofline_table", "render_experiments"):
        return {"n_ok": res["n_ok"], "n_cells": res["n_cells"]}
    return {}


if __name__ == "__main__":
    main()
