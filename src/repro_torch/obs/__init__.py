"""Observability plane of the port: metrics, tracing, health, SLO,
flight recorder.

`metrics` holds the mergeable counters/gauges/histograms every serving
layer records into; `trace` holds the Span/Tracer/TraceLog machinery
that follows a ticket from admission to the serve step and exports a
Perfetto-loadable Chrome trace; `health` is the statusz/watchdog
introspection plane; `slo` computes multi-window error-budget burn over
merged snapshots; `events` is the bounded flight-recorder ring behind
postmortem bundles.  Host only; the port's copies of the reference's
``obs`` modules.  A ticket's trace follows it across the process
boundary of the process cell (``repro_torch.cluster.proc``): workers
ship entry deltas and the parent rebases them with
:func:`adjust_remote_entries`.
"""
from .events import EventLog, FlightRecorder
from .health import HeartbeatWatchdog, statusz
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_snapshots,
    metric_key,
)
from .slo import SLOConfig, SLOMonitor, fold_snapshot
from .trace import (
    NULL_SPAN,
    NULL_TRACER,
    Span,
    TraceLog,
    Tracer,
    active,
    adjust_remote_entries,
    collective,
    collectives,
    export_chrome_entries,
    host_sync,
    host_syncs,
    scope,
    tracing,
    write_chrome_entries,
)

__all__ = [
    "Counter",
    "EventLog",
    "FlightRecorder",
    "Gauge",
    "HeartbeatWatchdog",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "NULL_TRACER",
    "SLOConfig",
    "SLOMonitor",
    "Span",
    "TraceLog",
    "Tracer",
    "active",
    "adjust_remote_entries",
    "collective",
    "collectives",
    "export_chrome_entries",
    "fold_snapshot",
    "host_sync",
    "host_syncs",
    "merge_snapshots",
    "metric_key",
    "scope",
    "statusz",
    "tracing",
    "write_chrome_entries",
]
