"""What one profiled call ran on the card, from ``torch.profiler``'s trace.

``profile(fn)`` runs ``fn`` under the profiler (CPU and CUDA activity) and
reduces the trace to a ``Trace``: the window (first to last event), the
device's busy time (the union of its operations' intervals), each device
operation's time by name, the kernel count (memory copies and sets left
out), and the longest idle gaps with the host operation that overlapped each
most.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    n_kernels: int
    device_s: dict          # device operation's label -> seconds, summed
    idle_gaps: list         # [(host operation, seconds)], longest first

    def kernel_s(self, kernel: str) -> float | None:
        """Seconds of the device operations whose name is ``kernel``, or
        None when none ran."""
        s = [t for name, t in self.device_s.items()
             if short_name(name) == kernel]
        return sum(s) if s else None


def label(name: str) -> str:
    """A device operation's name without its arguments, anonymous and
    library namespaces, at most 100 characters: the breakdown's label."""
    n = name.replace("(anonymous namespace)::", "").replace("at::native::", "")
    n = n.replace("std::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(n):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            n = n[:i]
            break
    return n.strip()[:100]


def short_name(name: str) -> str:
    """A kernel's bare name: no namespace, template or arguments."""
    base = label(name).split("<", 1)[0].strip()
    return base.rsplit(" ", 1)[-1].rsplit("::", 1)[-1] or name


def merge(intervals):
    """Sorted, non-overlapping union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(device_events, host_events, n_gaps: int = 10) -> Trace:
    """``device_events`` and ``host_events``: (name, start_us, end_us);
    host events are the outermost host operations."""
    if not device_events:
        raise RuntimeError("the profiler saw no operation on the device")
    starts = [e[1] for e in (*device_events, *host_events)]
    ends = [e[2] for e in (*device_events, *host_events)]
    t0, t1 = min(starts), max(ends)
    busy = merge((s, e) for _, s, e in device_events)
    device_s, n_kernels = {}, 0
    for name, s, e in device_events:
        key = label(name)
        device_s[key] = device_s.get(key, 0.0) + (e - s) * 1e-6
        n_kernels += not name.startswith(("Memcpy", "Memset"))
    edges = [[t0, t0], *busy, [t1, t1]]
    gaps = [(a[1], b[0]) for a, b in zip(edges, edges[1:]) if b[0] > a[1]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = sorted(host_events, key=lambda e: e[1])
    idle = []
    for a, b in gaps[:n_gaps]:
        best, cover = "device idle, host silent", 0.0
        for name, s, e in host:
            if s >= b:
                break
            c = min(e, b) - max(s, a)
            if c > cover:
                best, cover = name, c
        idle.append((best, (b - a) * 1e-6))
    return Trace(window_s=(t1 - t0) * 1e-6,
                 busy_s=sum(e - s for s, e in busy) * 1e-6,
                 n_kernels=n_kernels, device_s=device_s, idle_gaps=idle)


def profile(fn) -> Trace:
    """Run ``fn()`` (which must leave its work finished on the card) under
    the profiler and summarize what ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device, host = [], []
    for ev in prof.events():
        item = (ev.name, float(ev.time_range.start),
                float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            device.append(item)
        elif ev.cpu_parent is None:
            host.append(item)
    return summarize(device, host)
