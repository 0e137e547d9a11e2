"""Measured work/span profile: fit dispatch burden from trace spans.

Port of ``repro.obsv.profile`` (numpy, on the port's ``core/cilkview.py``).

``core/cilkview.py`` models GSCPM as a burdened fork-join dag whose
burden terms (``t_spawn`` per task, ``t_round`` per dispatch) were, until
this module, *guessed*. The paper measures them (Table I attributes the
grain-size cliff to spawn/scheduling overhead); so do we: every traced
round/quantum span records how many schedule rounds and sync iterations
it covered, so its duration decomposes as

    dur ≈ t_round · rounds + t_sync_iter · iterations

and a least-squares fit over spans of *different grains* separates the
per-dispatch burden (``t_round``) from the per-iteration device work
(``t_sync_iter``). One sync iteration advances ``W`` lanes, so the
per-playout unit cost is ``t_sync_iter / W`` — which converts the fitted
seconds into the DagModel's ``t_iter`` units and yields a *measured*
Fig 9 overlay (``benchmarks_torch/fig9_mapping.py``).

Span vocabulary consumed here (recorded by ``gscpm_search(tracer=...)``
and ``gscpm_search_batch(tracer=...)``): any ``X`` event whose ``args``
carry ``rounds`` and ``iterations``; ``lane_iterations`` and ``workers``
ride along for bookkeeping. A traced search synchronises the device
inside each span, so a span's duration includes the device work it
dispatched. The ``jit_compile`` instants that taint a span are the port's
kernel builds (``obsv.trace.CompileWatch``).
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.core.cilkview import (
    DagModel,
    burdened_parallelism,
    parallelism,
    speedup_bound,
)

PROFILE_SPAN_NAMES = ("gscpm_round", "quantum")


def load_events(obj) -> list[dict]:
    """Accept a TraceRecorder, trace dict, event list, or file path."""
    if hasattr(obj, "events"):
        return list(obj.events)
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if isinstance(obj, dict):
        return list(obj.get("traceEvents", []))
    return list(obj)


def dispatch_spans(events, names=PROFILE_SPAN_NAMES) -> list[dict]:
    """The ``X`` spans carrying a (rounds, iterations) work annotation."""
    out = []
    for ev in events:
        args = ev.get("args") or {}
        if (ev.get("ph") == "X" and ev.get("name") in names
                and "rounds" in args and "iterations" in args
                and args["rounds"] > 0):
            out.append(ev)
    return out


def fit_dispatch_profile(trace, n_workers: int | None = None) -> dict:
    """Least-squares (t_round_s, t_sync_iter_s) from dispatch spans.

    Needs spans at more than one grain (rounds:iterations ratio) to
    separate the two terms; with a rank-deficient design the whole
    duration is attributed to iterations and ``t_round_s`` reports 0 —
    flagged by ``identifiable: False``. Negative solutions (host noise)
    are clamped to 0 and the other term refit. Spans that overlap a
    ``jit_compile`` instant are excluded — a compile stall inside a span
    is setup cost, not dispatch burden, and one such span can dwarf every
    honest measurement (``n_excluded_compile`` reports how many).
    """
    events = load_events(trace)
    spans = dispatch_spans(events)
    if not spans:
        raise ValueError("trace contains no dispatch spans with "
                         "rounds/iterations args (record one with "
                         "gscpm_search(tracer=...))")
    compile_ts = [ev["ts"] for ev in events
                  if ev.get("ph") == "i" and ev.get("name") == "jit_compile"]
    n_excluded = 0
    if compile_ts:
        # a compile stall lands inside the span that triggered it, but the
        # watch only OBSERVES it at the next poll — so blame any span
        # containing the instant, else the span that ended most recently
        # before it
        ok = [True] * len(spans)
        for c in compile_ts:
            inside = [i for i, s in enumerate(spans)
                      if s["ts"] <= c <= s["ts"] + s["dur"]]
            if inside:
                for i in inside:
                    ok[i] = False
            else:
                before = [(s["ts"] + s["dur"], i)
                          for i, s in enumerate(spans)
                          if s["ts"] + s["dur"] <= c]
                if before:
                    ok[max(before)[1]] = False
        clean = [s for s, k in zip(spans, ok) if k]
        if clean:
            n_excluded = len(spans) - len(clean)
            spans = clean
    rounds = np.asarray([s["args"]["rounds"] for s in spans], float)
    iters = np.asarray([s["args"]["iterations"] for s in spans], float)
    dur_s = np.asarray([s["dur"] for s in spans], float) * 1e-6
    if n_workers is None:
        ws = {s["args"].get("workers") for s in spans} - {None}
        n_workers = int(max(ws)) if ws else 1

    a = np.stack([rounds, iters], axis=1)
    identifiable = bool(np.linalg.matrix_rank(a) >= 2)
    t_round = t_sync = -1.0
    if identifiable:
        sol, *_ = np.linalg.lstsq(a, dur_s, rcond=None)
        t_round, t_sync = float(sol[0]), float(sol[1])
    if t_sync <= 0.0:
        # degenerate: rank-deficient design, or dispatch noise swamped the
        # device term. Calibrate t_sync on the coarsest-grain span (where
        # per-iteration work dominates its duration — an upper bound, the
        # classic single-point calibration) and refit the round burden on
        # the residual. Keeps t_iter_s > 0 so the unit conversion the
        # DagModel consumes stays meaningful.
        identifiable = False
        k = int(np.argmax(iters / np.maximum(rounds, 1.0)))
        t_sync = float(dur_s[k] / max(iters[k], 1.0))
        r = dur_s - t_sync * iters
        t_round = float(np.sum(rounds * r) / max(np.sum(rounds**2), 1e-12))
    elif t_round < 0.0:
        t_round = 0.0
        t_sync = float(np.sum(iters * dur_s)
                       / max(np.sum(iters * iters), 1e-12))
    t_round, t_sync = float(max(0.0, t_round)), float(max(0.0, t_sync))

    t_iter_s = t_sync / max(1, n_workers)    # per-playout unit cost
    resid = dur_s - (t_round * rounds + t_sync * iters)
    return {
        "n_spans": len(spans),
        "n_excluded_compile": n_excluded,
        "n_workers": n_workers,
        "identifiable": bool(identifiable),
        "t_round_s": t_round,
        "t_sync_iter_s": t_sync,
        "t_iter_s": t_iter_s,
        # burden terms in t_iter units — what DagModel consumes
        "t_round_units": t_round / max(t_iter_s, 1e-12),
        "t_spawn_units": t_round / max(t_iter_s, 1e-12) / max(1, n_workers),
        "fit_rms_rel": float(np.sqrt(np.mean(resid ** 2))
                             / max(np.mean(dur_s), 1e-12)),
    }


def measured_dag_model(profile: dict) -> DagModel:
    """The cilkview model with MEASURED burden terms (t_iter-normalized).

    ``t_spawn`` is the per-task share of the round dispatch burden — each
    round spawns up to W lane-tasks, so the burden a single task carries
    is ``t_round / W``.
    """
    return DagModel(t_iter=1.0,
                    t_spawn=profile["t_spawn_units"],
                    t_round=profile["t_round_units"])


def measured_vs_analytic(profile: dict, n_playouts: int,
                         task_counts, n_cores: int) -> list[dict]:
    """Per-grain table: analytic (guessed-burden) vs measured-burden
    parallelism and speedup bounds — the Fig 9 comparison as rows."""
    analytic = DagModel()
    measured = measured_dag_model(profile)
    rows = []
    for t in task_counts:
        g = max(1, n_playouts // t)
        rows.append({
            "n_tasks": int(t),
            "grain": int(g),
            "parallelism_analytic": parallelism(t, g, analytic),
            "parallelism_measured": parallelism(t, g, measured),
            "burdened_parallelism_measured":
                burdened_parallelism(t, g, n_cores, measured),
            "bound_analytic": speedup_bound(t, g, n_cores, analytic),
            "bound_measured": speedup_bound(t, g, n_cores, measured),
        })
    return rows


def format_table(rows: list[dict]) -> str:
    """Console rendering of ``measured_vs_analytic`` rows."""
    hdr = (f"{'tasks':>6} {'grain':>6} {'par(analytic)':>14} "
           f"{'par(measured)':>14} {'bound(a)':>9} {'bound(m)':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['n_tasks']:>6} {r['grain']:>6} "
            f"{r['parallelism_analytic']:>14.1f} "
            f"{r['parallelism_measured']:>14.1f} "
            f"{r['bound_analytic']:>9.2f} {r['bound_measured']:>9.2f}")
    return "\n".join(lines)
