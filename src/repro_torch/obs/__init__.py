"""Observability plane of the port: metrics and tracing.

`metrics` holds the mergeable counters/gauges/histograms the serving
engine records into; `trace` holds the Span/Tracer/TraceLog machinery
that follows a ticket from admission to the serve step and exports a
Perfetto-loadable Chrome trace.  Host only; the port's copies of the
reference's ``obs`` modules, as far as one serving process needs them.
"""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_snapshots,
    metric_key,
)
from .trace import (
    NULL_SPAN,
    NULL_TRACER,
    Span,
    TraceLog,
    Tracer,
    export_chrome_entries,
    write_chrome_entries,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "NULL_TRACER",
    "Span",
    "TraceLog",
    "Tracer",
    "export_chrome_entries",
    "merge_snapshots",
    "metric_key",
    "write_chrome_entries",
]
