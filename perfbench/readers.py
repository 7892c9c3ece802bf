"""The arithmetic of the per-layer metrics.  Each metric of
``BENCHMARK.json`` has its own reader, ``metrics/<name>.py``, which calls
one of these with the end-to-end metric it is split by.  A reader that
finds nothing to read returns None, and the metric is left out of the
result line; a share of a roofline is never reported as 0 for want of a
reading."""
from __future__ import annotations

from typing import Optional


def step_roofline(ctx, kind: str) -> Optional[float]:
    """The share of the card's memory roofline that one whole call
    reaches: its compulsory bytes over (the mean host-clock time of the
    window's untraced calls x the published bandwidth), in %."""
    if ctx.kind != kind or not ctx.hbm_bytes_per_s or not ctx.mean_call_s:
        return None
    return 100.0 * ctx.step_bytes / (ctx.mean_call_s * ctx.hbm_bytes_per_s)


def call_p95_ms(ctx, kind: str) -> Optional[float]:
    """The 95th percentile of the window's untraced calls, dispatch to
    answers on the host, in ms: the end-to-end tail of a cell whose runs
    spread too widely to bound it."""
    if ctx.kind != kind or not ctx.p95_call_s:
        return None
    return 1e3 * ctx.p95_call_s


def kernel_roofline(ctx, kind: str, kernel: str) -> Optional[float]:
    """The share of the memory roofline that the device time of the
    kernels named ``kernel`` reaches on the plane-blocks that the traced
    calls' u counts, in %."""
    if ctx.kind != kind or ctx.trace is None or not ctx.hbm_bytes_per_s:
        return None
    seconds = ctx.trace.device_seconds(kernel)
    if seconds <= 0.0:
        return None
    return 100.0 * ctx.traced_plane_bytes / (seconds * ctx.hbm_bytes_per_s)


def launches_per_query(ctx, kind: str) -> Optional[float]:
    """The host's kernel-launch API calls in the traced slice over its
    queries."""
    if ctx.kind != kind or ctx.trace is None or ctx.trace.runtime_events == 0:
        return None
    return ctx.trace.launches / ctx.traced_queries


def idle_share(ctx, kind: str) -> Optional[float]:
    """100 x (1 - the union of the device's operation intervals over the
    traced slice's wall time)."""
    if ctx.kind != kind or ctx.trace is None or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
