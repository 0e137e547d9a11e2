"""Where one profiled call's device time went, stage by stage of the search.

While a profiler records, the program opens a range named ``gscpm.<stage>``
around each stage of a call (``repro_torch.obsv.trace.stage``): ``init``,
``round_inputs``, then per sync iteration ``keys``, ``descent``,
``propose``, ``expand``, ``playout``, ``backup`` (and ``metrics`` with the
counters on), ``merge`` and ``summary``. ``reduce`` puts each device
operation down to the stage whose range was open on the host when the
operation was launched: the profiler's correlation id ties the operation to
its runtime launch call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...),
whose host time lies in one range. Device time is never matched by overlap:
a kernel runs long after the range that launched it has closed.

Per stage:

- ``device_s``: the stage's share of the device's busy time (the union of
  every operation's interval; an instant two operations share goes to the
  one that started first), so the stages and ``UNSTAGED`` add up to the
  busy time that ``trace.summarize`` reads;
- ``launches``: its kernels (memory copies and sets left out, as
  ``trace.summarize`` counts them);
- ``waits``: host calls in its ranges that block until the device drains
  (``WAITS``);
- ``idle_s``: the idle gaps that its operations end (a gap before the
  first operation counts from the first range's start);
- ``host_s``: the host time its ranges were open.

Operations launched outside every range, or whose launch the trace lacks,
go to ``UNSTAGED``; the idle time after the last operation is
``tail_idle_s``.

    python3 mctsbench/stages.py --workload <cell> --seed <n>

sets a cell up as a run does (``harness.run_cell``), profiles one call on
its first call's inputs and prints the stage table per sync iteration and
one JSON line. The harness does not read this module yet: a per-layer
metric of a stage needs ``trace.profile`` to hand its events to ``reduce``.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import time

PREFIX = "gscpm."
UNSTAGED = "unstaged"
WAITS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
                   "cudaMemset"})


@dataclasses.dataclass
class Stage:
    device_s: float = 0.0
    launches: int = 0
    waits: int = 0
    idle_s: float = 0.0
    host_s: float = 0.0


@dataclasses.dataclass
class Stages:
    stages: dict            # stage -> Stage, in order of first range
    busy_s: float           # union of the device operations' intervals
    tail_idle_s: float      # after the last operation, to the last range's end
    wait_calls: dict        # blocking runtime call -> count


def _outermost(ranges):
    """The ranges that no other range holds, sorted by start."""
    out = []
    for r in sorted(ranges, key=lambda r: (r[1], -r[2])):
        if out and r[2] <= out[-1][2]:
            continue
        out.append(r)
    return out


def reduce(ranges, launches: dict, device_ops, calls) -> Stages:
    """``ranges``: the program's stage ranges on the host, (stage, start_us,
    end_us); ``launches``: {correlation id: host time in us} of the runtime
    calls that launched device operations; ``device_ops``: (name, start_us,
    end_us, correlation id); ``calls``: every runtime call on the host,
    (name, start_us). One clock for all."""
    ranges = _outermost(ranges)
    starts = [r[1] for r in ranges]
    stages = {}
    for name, s, e in ranges:
        stages.setdefault(name, Stage()).host_s += (e - s) * 1e-6

    def at(t):
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][2]:
                return stages[ranges[i][0]]
        return stages.setdefault(UNSTAGED, Stage())

    waits = {}
    for name, t in calls:
        if name in WAITS:
            at(t).waits += 1
            waits[name] = waits.get(name, 0) + 1
    ops = sorted(device_ops, key=lambda o: (o[1], o[2]))
    covered = min([*starts[:1], *(o[1] for o in ops[:1])], default=0.0)
    busy = 0.0
    for name, s, e, corr in ops:
        st = at(launches.get(corr))
        if s > covered:
            st.idle_s += (s - covered) * 1e-6
        share = max(0.0, e - max(s, covered))
        st.device_s += share * 1e-6
        busy += share
        st.launches += not name.startswith(("Memcpy", "Memset"))
        covered = max(covered, e)
    end = max([covered, *(r[2] for r in ranges[-1:])])
    return Stages(stages=stages, busy_s=busy * 1e-6,
                  tail_idle_s=(end - covered) * 1e-6, wait_calls=waits)


def from_profiler(prof) -> Stages:
    """``reduce`` over a finished ``torch.profiler`` session's events. The
    ranges' own device-side shadows (a ``gscpm.*`` user annotation on the
    device's timeline, where the profiler draws one) are no operations."""
    from torch.autograd import DeviceType

    ranges, launches, ops, calls = [], {}, [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            if not ev.name.startswith(PREFIX):
                ops.append((ev.name, s, e, ev.id))
        elif ev.name.startswith(PREFIX):
            ranges.append((ev.name[len(PREFIX):], s, e))
        elif ev.name.startswith("cu"):
            calls.append((ev.name, s))
            launches[ev.id] = s
    return reduce(ranges, launches, ops, calls)


def table(st: Stages, iterations: int) -> list[str]:
    """The stage table, per sync iteration of the call."""
    per = 1.0 / iterations
    lines = [f"{'stage':<13}{'device ms':>10}{'launches':>10}{'waits':>8}"
             f"{'idle ms':>9}{'host ms':>9}"]
    for name, s in st.stages.items():
        lines.append(f"{name:<13}{1e3 * s.device_s * per:>10.3f}"
                     f"{s.launches * per:>10.2f}{s.waits * per:>8.2f}"
                     f"{1e3 * s.idle_s * per:>9.3f}{1e3 * s.host_s * per:>9.3f}")
    lines.append(f"busy {1e3 * st.busy_s * per:.3f} ms, tail idle "
                 f"{1e3 * st.tail_idle_s * per:.3f} ms an iteration over "
                 f"{iterations} iterations; blocking calls {st.wait_calls}")
    return lines


def as_dict(st: Stages) -> dict:
    return {"stages": {k: dataclasses.asdict(v)
                       for k, v in st.stages.items()},
            "busy_s": st.busy_s, "tail_idle_s": st.tail_idle_s,
            "wait_calls": st.wait_calls}


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mctsbench.manifest import Manifest
    from mctsbench.program import Program

    if not torch.cuda.is_available():
        print("mctsbench.stages: no CUDA card", file=sys.stderr)
        return 2
    man = Manifest(root)
    cell = man.cell(args.workload)
    params = man.workload_params(args.workload)
    config = man.config(cell["config"])
    traffic = man.module("traffic", params["kind"]).Traffic(
        params, config, int(args.seed) % 2**64)
    prog = Program(config, params, "cuda:0")
    prog.load_kernels()
    traffic.setup(prog)
    traffic.warm_up(prog)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traffic.step(prog, 0, [])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = from_profiler(prof)
    for line in table(st, traffic.iterations):
        print(line, file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "iterations": traffic.iterations, "call_s": wall,
                      "card": torch.cuda.get_device_name(0),
                      **as_dict(st)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
