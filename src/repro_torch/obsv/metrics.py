"""Host-plane counter/gauge registry with JSON + Prometheus output.

Port of ``repro.obsv.metrics``: pure host code, the port's own copy.

The trace plane (``obsv.trace``) answers "where did the time go"; this
registry answers "how much happened": monotonically increasing counters
(requests admitted, quanta dispatched, playouts committed, preemptions)
and point-in-time gauges (queue depth, active slots). Snapshots serialize
to JSON for artifacts, and ``exposition()`` renders the Prometheus text
format for scrape-style consumption.

A search loop updates a registry when one is attached; attaching costs two
dict lookups per event, detaching costs nothing.
"""

from __future__ import annotations

import dataclasses
import json
import time


@dataclasses.dataclass
class Metric:
    name: str
    kind: str           # "counter" | "gauge"
    help: str = ""
    value: float = 0.0

    def inc(self, amount: float = 1.0):
        self.value += amount

    def set(self, value: float):
        self.value = value


class MetricsRegistry:
    """Flat name -> Metric map; create-on-first-use accessors."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._t0 = time.time()

    def counter(self, name: str, help: str = "") -> Metric:
        return self._get(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Metric:
        return self._get(name, "gauge", help)

    def _get(self, name: str, kind: str, help: str) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Metric(name=name, kind=kind, help=help)
        elif m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}")
        if help and not m.help:
            m.help = help
        return m

    # -- output -----------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "uptime_s": time.time() - self._t0,
            "metrics": {m.name: {"type": m.kind, "help": m.help,
                                 "value": m.value}
                        for m in sorted(self._metrics.values(),
                                        key=lambda m: m.name)},
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path

    def exposition(self) -> str:
        """Prometheus text format (one HELP/TYPE/sample block per metric)."""
        lines = []
        for m in sorted(self._metrics.values(), key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            v = m.value
            lines.append(f"{m.name} {int(v) if v == int(v) else v}")
        return "\n".join(lines) + "\n"
