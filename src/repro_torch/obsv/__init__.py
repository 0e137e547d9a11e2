"""Search observatory of the port — two-plane observability.

Port of ``repro.obsv``, same exports.

Device plane (``search_metrics``): a ``SearchMetrics`` NamedTuple of int32
counters on the search's device, carried through the search chunks as an
optional accumulator — the search results stay bit-identical with metrics
on or off, and the host reads the accumulator once, at the end.

Host plane (``trace`` / ``metrics``): a Chrome/Perfetto trace-event span
recorder for the search's rounds and the kernel library's builds, plus a
counter/gauge registry with JSON snapshots and a Prometheus-style text
exposition.

``profile`` closes the loop: it fits the measured per-round dispatch cost
and per-iteration cost from recorded spans and feeds them into the
analytic ``core/cilkview.py`` DagModel — measured, not guessed, burden
terms for the Fig 9 overlay.
"""

from repro_torch.obsv.search_metrics import (  # noqa: F401
    SearchMetrics,
    accumulate_iteration,
    init_search_metrics,
    init_search_metrics_forest,
    merge_metrics,
    summarize_metrics,
)
from repro_torch.obsv.trace import TraceRecorder, validate_trace  # noqa: F401
from repro_torch.obsv.metrics import MetricsRegistry  # noqa: F401
