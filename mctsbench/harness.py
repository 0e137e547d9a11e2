"""One run of one cell: set-up, the measured window, the traced call, and the
comparison that decides ``correct``.

The cell's traffic kind (``traffic/<kind>.py``, named by
``workloads/<cell>.json``) owns what a call is: its ``Traffic`` makes the
inputs from the seed and offers ``setup``, ``warm_up``, ``step`` (one timed
call), ``counts`` (the cost stages' inputs) and ``reference`` (the plain
reference's answers). This module only times and judges.

- **Set-up** (``setup_s``): from the process's start (``t0``) through the
  imports, the traffic's inputs, the card, the kernel library, the inputs on
  the card and the traffic's warm-up at the cell's own size; each part is
  logged.
- **Window**: whole calls of the cell's traffic, from call 0 until the
  first call that ends after ``seconds``. Of every call, ``KEPT`` members
  (one from each of ``KEPT`` equal slices of the batch, drawn from the
  seed) have their answers copied to the host when it returns.
- **Traced run** (``trace``): after the window, the next call's inputs run
  twice: once with the program's counters on and the cell's kernel probes
  at their dispatch points (the work counts), once under the profiler (the
  times); then the per-layer metrics.
- **Correct**: once the window has closed and the card's peak is read,
  every kept answer of every window call is searched again by the plain
  reference, in up to eight processes, and must equal the program's
  (``reference.compare``). ``attempted`` is the number of answers checked,
  ``failed`` the number that part.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from mctsbench import work
from mctsbench.manifest import ROOT, Manifest
from mctsbench.reference import compare, search

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KEPT = 8


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def kept_members(seed: int, call: int, members: int,
                 k: int = KEPT) -> list[int]:
    """The members of call ``call`` whose answers are kept: one drawn from
    each of ``k`` equal slices of the batch."""
    rng = np.random.default_rng([seed, 2, call])
    k = min(k, members)
    edges = [s * members // k for s in range(k + 1)]
    return [int(rng.integers(a, b)) for a, b in zip(edges, edges[1:])]


@contextlib.contextmanager
def probing(man: Manifest, names):
    """Wrap the dispatch point in ``repro_torch.kernels.ops`` of each probe
    in ``names`` to add up the work of every call; yields {probe: sums}."""
    from repro_torch.kernels import ops
    sums, undo = {}, []
    for name, probe in man.named("probes", names).items():
        inner = getattr(ops, probe.TARGET)
        acc = sums[name] = {"bytes": 0.0, "ops": 0.0, "calls": 0,
                            "kernel": probe.KERNEL}

        def counted(*args, _inner=inner, _probe=probe, _acc=acc, **kw):
            out = _inner(*args, **kw)
            b, o = _probe.work(args, out)
            _acc["bytes"] += b
            _acc["ops"] += o
            _acc["calls"] += 1
            return out

        setattr(ops, probe.TARGET, counted)
        undo.append((probe.TARGET, inner))
    try:
        yield sums
    finally:
        for target, inner in undo:
            setattr(ops, target, inner)


def stage_work(man: Manifest, params: dict, counts: dict) -> dict:
    """{stage: (bytes, operations)} of the cell's cost stages."""
    return {k: mod.work(counts)
            for k, mod in man.named("costs", params["costs"]).items()}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root=ROOT, device="cuda:0", t0: float | None = None,
             log=sys.stderr) -> dict | None:
    """The result line of one run, or None when a forbidden module was
    loaded (named on ``log``). ``root`` holds the manifest (the tests add
    throwaway cells in a copy), ``device`` is the card (the tests' CPU) and
    ``t0`` the process's start."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    marks = [("torch", time.perf_counter())]

    def mark(what):
        marks.append((what, time.perf_counter()))

    man = Manifest(root)
    cell = man.cell(name)
    config = man.config(cell["config"])
    params = man.workload_params(name)
    if (params["config"], params["traffic"]) != (cell["config"],
                                                 cell["traffic"]):
        raise ValueError(f"workloads/{name}.json names {params['config']!r} "
                         f"x {params['traffic']!r}, BENCHMARK.json "
                         f"{cell['config']!r} x {cell['traffic']!r}")
    seed = int(seed) % 2**64
    from mctsbench.program import Program
    mark("repro_torch")
    traffic = man.module("traffic", params["kind"]).Traffic(params, config,
                                                            seed)
    mark("inputs")
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prog = Program(config, params, device)
    if cuda:
        torch.empty(0, device=device)
        torch.cuda.reset_peak_memory_stats()
    mark("CUDA context")
    prog.load_kernels()
    mark("kernels")
    traffic.setup(prog)
    sync()
    mark("inputs on the card")
    traffic.warm_up(prog)
    sync()
    mark("warm-up")
    setup_s = marks[-1][1] - t0
    print("set-up: " + ", ".join(
        f"{k} {b - a:.2f} s" for (_, a), (k, b) in
        zip([("", t0), *marks], marks)), file=log)

    kept, playouts, iterations, nodes, ends = [], 0, 0, [], []
    w0 = time.perf_counter()
    while True:
        i = len(kept)
        members = kept_members(seed, i, traffic.members)
        step = traffic.step(prog, i, members)
        ends.append(time.perf_counter())
        kept.append((i, members, step.kept))
        playouts += step.playouts
        iterations += step.iterations
        nodes.append(step.stats["tree_nodes"])
        del step
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    n_calls = len(kept)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    obs = {"setup_s": setup_s, "window_s": window_s, "playouts": playouts,
           "iterations": iterations, "peak_bytes": peak,
           "peaks": work.peaks(man.bench / "peaks.json")}
    if trace:
        obs.update(traced(man, params, prog, traffic, n_calls))

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=log)
        return None

    t_ref = time.perf_counter()
    got = [a for _, _, stash in kept for a in prog.answers(stash)]
    picks = [(i, members) for i, members, _ in kept]
    del kept
    want = traffic.reference(
        picks, log=search.card_log(device) if cuda else None,
        workers=search.reference_workers() if cuda else 1)
    checks, notes = compare.judge(got, want)
    ok = compare.correct(checks, len(want))

    metrics = {}
    for m in man.metrics(name, trace):
        value = man.module("metrics", m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        from mctsbench.device import stamp
        dev["power_limit"] = stamp(torch.device(device).index or 0)[
            "power_limit"]
    result = {"correct": ok, "attempted": len(want),
              "failed": checks["parted_members"]["value"],
              "metrics": metrics, "device": dev}
    if trace and obs.get("trace"):
        tr = obs["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        top = sorted(tr.device_s.items(), key=lambda kv: kv[1], reverse=True)
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in tr.idle_gaps[:10]]}
    result["checks"] = checks
    lengths = np.diff([w0, *ends])
    filled = np.asarray(nodes, dtype=np.float64)
    print(f"window: {n_calls} calls of {traffic.members} members, "
          f"{window_s:.3f} s (calls {', '.join(f'{x:.3f}' for x in lengths)}"
          f" s); trees filled: mean {filled.mean():.1f}, most "
          f"{int(filled.max())} of {prog.cfg.tree_cap} rows; reference: "
          f"{len(want)} members in {time.perf_counter() - t_ref:.1f} s",
          file=log)
    for note in notes:
        print(f"parted: {note}", file=log)
    return result


def traced(man: Manifest, params: dict, prog, traffic, i: int) -> dict:
    """The traced run's extra observations from call ``i``'s inputs: work
    counts (the program's counters and the cell's kernel probes) from one
    call, times from a second, profiled one."""
    from mctsbench import trace

    with probing(man, params.get("probes", [])) as probes:
        step = traffic.step(prog, i, [], metrics=True)
    counts = traffic.counts(step, i)
    iterations = step.iterations
    del step

    def profiled_call():
        traffic.step(prog, i, [])

    return {"trace": trace.profile(profiled_call),
            "traced_iterations": iterations,
            "stage_work": stage_work(man, params, counts),
            "counted_iterations": counts["iterations"], "probes": probes}
