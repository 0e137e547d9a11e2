"""Host-plane span recorder: Chrome/Perfetto trace-event JSON.

Port of ``repro.obsv.trace``, with the same event format and names. The
search loops run on the host, dispatching rounds of device work; their
time structure (dispatch, device sync, kernel-build stalls) is what the
paper's profiling chapters measure. ``TraceRecorder`` records that
structure as trace-event JSON — open ``chrome://tracing`` or
https://ui.perfetto.dev and load the file.

Event vocabulary (the ``ph`` field of the trace-event format):

- ``X`` *complete* spans with a duration — rounds, device syncs
  (``TraceRecorder.span`` context manager);
- ``B``/``E`` nested begin/end pairs for open-ended phases;
- ``i`` *instant* events — kernel builds (``jit_compile``), or anything a
  caller marks;
- ``C`` counter tracks;
- ``M`` metadata naming the process/thread tracks.

Timestamps are microseconds from the recorder's creation
(``time.perf_counter`` based, so spans compose with the search loops' own
telemetry clocks). Recording never raises into the traced code path: a
``None`` recorder is the off switch and every hook guards on it.

``CompileWatch`` turns compile stalls into trace events. PyTorch runs
eagerly and the port has no jit cache to probe: what stalls a span is the
build (or first load) of the CUDA kernels' library, so by default a watch
reads ``kernels._build.builds``, the process's build counter, and on each
``poll()`` reports how far it grew. ``poll_compiles`` emits one
``jit_compile`` instant per watch that grew — the name the JAX package
uses, so ``obsv.profile``'s rule that excludes a tainted span is the same.

``stage(name)`` marks a stage of the search for ``torch.profiler``: a host
range ``gscpm.<name>`` on the profiler's clock while a session records, to
which the profiler ties every kernel launched inside it; with no session,
one check of the profiler's state.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable

import torch

from repro_torch.kernels import _build

_NO_STAGE = contextlib.nullcontext()


def stage(name: str):
    """The profiler range ``gscpm.<name>`` while a profiler records, else a
    shared no-op context. The search's stage ranges are the outermost ranges
    it opens (``core.gscpm``, ``core.root_parallel``) and follow each other
    on one thread, so a trace's top-level host events name the stage each
    device operation was launched in, and their order names the round and
    the iteration (``round_inputs`` opens a round, ``run_chunk``'s ``keys``
    an iteration)."""
    if not torch.autograd._profiler_enabled():
        return _NO_STAGE
    # not ``torch.profiler.record_function``: a user annotation also gets a
    # shadow on the device's timeline, which a reader of device events
    # would take for an operation covering the stage's idle gaps
    return torch._C._profiler._RecordFunctionFast("gscpm." + name)


def kernel_builds() -> int:
    """Builds (or first loads) of the kernels' library in this process."""
    return _build.builds


class CompileWatch:
    """Build-count probe (see module docstring): ``probe`` is a zero-argument
    callable returning a count that only grows; the default is the kernel
    library's build counter."""

    def __init__(self, name: str, probe: Callable[[], int] | None = None):
        self.name = name
        self.probe = kernel_builds if probe is None else probe
        self.last = int(self.probe())
        self.total_new = 0

    def poll(self) -> int:
        """New builds since the previous poll."""
        cur = int(self.probe())
        delta = cur - self.last
        self.last = cur
        if delta > 0:
            self.total_new += delta
        return delta


class TraceRecorder:
    """Append-only trace-event buffer with span/instant/counter helpers."""

    def __init__(self, process_name: str = "repro-search",
                 clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.events: list[dict] = []
        self._watches: list[CompileWatch] = []
        self._open: dict[int, list[str]] = {}   # tid -> begin-stack
        self.metadata("process_name", {"name": process_name})

    # -- clock ------------------------------------------------------------
    def ts_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    # -- raw emitters -----------------------------------------------------
    def _emit(self, ph: str, name: str, *, ts: float | None = None,
              tid: int = 0, **extra) -> dict:
        ev = {"name": name, "ph": ph, "pid": 0, "tid": tid,
              "ts": self.ts_us() if ts is None else ts}
        ev.update({k: v for k, v in extra.items() if v is not None})
        self.events.append(ev)
        return ev

    def metadata(self, name: str, args: dict, tid: int = 0):
        self._emit("M", name, ts=0.0, tid=tid, args=args)

    def name_thread(self, tid: int, name: str):
        self.metadata("thread_name", {"name": name}, tid=tid)

    def instant(self, name: str, args: dict | None = None, tid: int = 0):
        self._emit("i", name, tid=tid, s="t", args=args)

    def begin(self, name: str, args: dict | None = None, tid: int = 0):
        self._open.setdefault(tid, []).append(name)
        self._emit("B", name, tid=tid, args=args)

    def end(self, tid: int = 0, args: dict | None = None):
        stack = self._open.get(tid, [])
        name = stack.pop() if stack else "?"
        self._emit("E", name, tid=tid, args=args)

    def complete(self, name: str, ts_us: float, dur_us: float,
                 args: dict | None = None, tid: int = 0):
        self._emit("X", name, ts=ts_us, tid=tid, dur=max(0.0, dur_us),
                   args=args)

    def counter(self, name: str, values: dict, tid: int = 0):
        self._emit("C", name, tid=tid, args=values)

    @contextlib.contextmanager
    def span(self, name: str, args: dict | None = None, tid: int = 0):
        """Complete-event context: ``with tracer.span("quantum", {...}):``.

        ``args`` may be mutated inside the block (e.g. to record how many
        rounds actually ran) — the event is emitted at exit.
        """
        t0 = self.ts_us()
        try:
            yield args
        finally:
            self.complete(name, t0, self.ts_us() - t0, args=args, tid=tid)

    # -- compile counting -------------------------------------------------
    def watch_compiles(self, name: str,
                       probe: Callable[[], int] | None = None
                       ) -> CompileWatch:
        """Track a build counter (default: the kernel library's);
        ``poll_compiles`` emits an instant ``jit_compile`` event whenever
        it grew."""
        w = CompileWatch(name, probe)
        self._watches.append(w)
        return w

    def poll_compiles(self):
        for w in self._watches:
            d = w.poll()
            if d > 0:
                self.instant("jit_compile", {"fn": w.name, "new_programs": d,
                                             "total": w.total_new})

    def compile_counts(self) -> dict[str, int]:
        self.poll_compiles()
        return {w.name: w.total_new for w in self._watches}

    # -- output -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


def validate_trace(obj: dict | str) -> int:
    """Structural check of a trace (dict or file path) -> event count.

    Raises ``ValueError`` on malformed traces: missing ``traceEvents``,
    events without name/ph/ts, ``X`` events without ``dur``, or unbalanced
    ``B``/``E`` pairs per (pid, tid) track. Used by the search launcher's
    ``--trace`` and by tests.
    """
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("trace has no traceEvents list")
    depth: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"complete event {i} missing dur: {ev}")
        track = (ev.get("pid", 0), ev.get("tid", 0))
        if ev["ph"] == "B":
            depth[track] = depth.get(track, 0) + 1
        elif ev["ph"] == "E":
            depth[track] = depth.get(track, 0) - 1
            if depth[track] < 0:
                raise ValueError(f"unbalanced E at event {i} on {track}")
    bad = {t: d for t, d in depth.items() if d != 0}
    if bad:
        raise ValueError(f"unclosed B spans: {bad}")
    json.dumps(events[: min(len(events), 64)])   # must be JSON-serializable
    return len(events)
