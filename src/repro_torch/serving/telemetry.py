"""Serving telemetry: per-request and per-batch accounting.

Latency is wall time from admission to response; u is the paper's index
blocks-accessed unit (shown linear in machine time), so both views of
"cost" are recorded per request.  ``summary()`` aggregates into the
p50/p99 + QPS shape every later scaling PR reports against.

Storage is split by what each consumer needs:

- **Counters / gauges / per-(level, category) histograms** live in a
  :class:`repro_torch.obs.MetricsRegistry` — mergeable across replicas (fleet
  stats are a fold over snapshots) and JSON-serializable for
  ``--metrics-json``.  The legacy attributes (``total_requests``,
  ``rejected``, ``level_counts``, ``queue_depth`` …) are read-through
  views onto those instruments.
- **Per-request / per-batch records** stay in bounded sliding windows
  (the engine is a long-running process; an unbounded list grows by one
  dict per request forever) because summary percentiles are *exact*
  ``np.quantile`` over the window — fixed histogram buckets are for the
  merged fleet view, not for the benches that compare p99s to fractions
  of a millisecond.

QPS is the windowed request count over the *window's own* time span
(first to last ``t_done`` currently in the deque).  Dividing by the
lifetime span — as an earlier version did — underestimates QPS once the
window wraps, because the numerator saturates at ``maxlen`` while the
denominator keeps growing.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional

import numpy as np

from repro_torch.obs import Counter, MetricsRegistry

__all__ = ["Telemetry", "pct", "LATENCY_MS_EDGES", "U_EDGES"]


class _RequestRecorder:
    """Pre-resolved instrument handles for one (level, category) cell.

    Hot paths fetch this bundle once (single tuple-keyed dict lookup)
    and then touch raw instruments — no ``metric_key`` label hashing,
    no per-histogram cache probes, per request."""

    __slots__ = ("level_counter", "lat_hist", "u_hist", "qwait_hist")

    def __init__(self, registry: MetricsRegistry, level_counter: Counter,
                 level: int, category: int):
        self.level_counter = level_counter
        self.lat_hist = registry.histogram(
            "serve.latency_ms", LATENCY_MS_EDGES,
            level=level, category=category)
        self.u_hist = registry.histogram(
            "serve.u", U_EDGES, level=level, category=category)
        self.qwait_hist = registry.histogram(
            "serve.queue_wait_ms", LATENCY_MS_EDGES,
            level=level, category=category)


def pct(xs, q: float) -> float:
    """Quantile with the empty-input-is-zero policy every serving
    surface (engine summary, cluster stats, benches) shares."""
    return float(np.quantile(xs, q)) if len(xs) else 0.0


_pct = pct

# Fixed bucket layouts shared by every replica so snapshots merge
# elementwise (see docs/observability.md for the rationale).
#: Latency / queue-wait edges in ms: 1-2-5 decades, 100 µs … 10 s.
LATENCY_MS_EDGES = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                    100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0)
#: u (index blocks accessed) edges: powers of two up to 128 Ki blocks.
U_EDGES = tuple(float(2 ** i) for i in range(18))


class Telemetry:
    def __init__(self, window: int = 65536,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.requests: Deque[dict] = deque(maxlen=window)
        self.batches: Deque[dict] = deque(maxlen=window)
        # Instrument handles — resolved once, recorded through on the
        # hot path without re-deriving (name, labels) keys per event.
        self._c_requests = self.registry.counter("serve.requests")
        self._c_cached = self.registry.counter("serve.cached")
        self._c_rejected = self.registry.counter("serve.rejected")
        # Depth gauges fold as SUMS across replicas: the fleet's merged
        # queue depth is total pending work (capacity math), not the
        # hottest replica's — peak-style gauges keep the max default.
        self._g_queue_depth = self.registry.gauge("serve.queue_depth",
                                                  agg="sum")
        self._g_inflight = self.registry.gauge("serve.inflight", agg="sum")
        self._level_counters: Dict[int, Counter] = {}
        self._hists: Dict[tuple, object] = {}
        # Pre-resolved per-(level, category) handle bundles: one dict
        # lookup on the hot path instead of three, and no label-dict
        # hashing per request (satellite of the batched data plane).
        self._recorders: Dict[tuple, "_RequestRecorder"] = {}
        # summary() memo: every record_* flips the dirty bit; a clean
        # summary is a cached-dict copy instead of a full window pass.
        self._summary_dirty = True
        self._summary_cache: Optional[Dict[str, float]] = None
        self._summary_compile_count = -1

    # ------------------------------------------------------------- clocks
    @staticmethod
    def now() -> float:
        return time.perf_counter()

    # ------------------------------------------- registry handle caches
    def _level_counter(self, level: int) -> Counter:
        c = self._level_counters.get(level)
        if c is None:
            c = self._level_counters[level] = self.registry.counter(
                "serve.requests_by_level", level=level)
        return c

    def _hist(self, name: str, edges, level: int, category: int):
        key = (name, level, category)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = self.registry.histogram(
                name, edges, level=level, category=category)
        return h

    def recorder(self, level: int, category: int) -> _RequestRecorder:
        """Handle bundle for one (level, category) cell — resolve once
        at construction / first sight, record through raw instruments
        thereafter."""
        key = (level, category)
        r = self._recorders.get(key)
        if r is None:
            r = self._recorders[key] = _RequestRecorder(
                self.registry, self._level_counter(level), level, category)
        return r

    # --------------------------------------------- legacy attribute views
    @property
    def total_requests(self) -> int:
        return self._c_requests.value

    @property
    def total_cached(self) -> int:
        return self._c_cached.value

    @property
    def rejected(self) -> int:
        return self._c_rejected.value

    @property
    def level_counts(self) -> Dict[int, int]:
        """ServiceLevel value -> lifetime count of served requests (the
        degradation-ladder mix; sheds never reach the engine)."""
        return {lvl: c.value for lvl, c in self._level_counters.items()}

    @property
    def queue_depth(self) -> int:
        return int(self._g_queue_depth.value)

    @property
    def inflight(self) -> int:
        return int(self._g_inflight.value)

    @property
    def peak_queue_depth(self) -> int:
        return int(self._g_queue_depth.max)

    @property
    def peak_inflight(self) -> int:
        return int(self._g_inflight.max)

    # ------------------------------------------------------------ records
    def record_request(self, *, category: int, latency_s: float, u: int,
                       cached: bool, t_done: float, level: int = 0) -> None:
        category = int(category)
        level = int(level)
        rec = self.recorder(level, category)
        self._c_requests.inc()
        if cached:
            self._c_cached.inc()
        rec.level_counter.inc()
        rec.lat_hist.record(latency_s * 1e3)
        rec.u_hist.record(u)
        self.requests.append({
            "category": category,
            "latency_s": float(latency_s),
            "u": int(u),
            "cached": bool(cached),
            "level": level,
            "t_done": float(t_done),
        })
        self._summary_dirty = True

    def record_requests(self, *, category: int, level: int,
                        latencies_s, us, cached: bool,
                        t_done: float) -> None:
        """Batch form of :meth:`record_request` for one (level,
        category) group: counters bump by ``n`` and histograms take the
        whole slab under one lock each, but the sliding window gets the
        same per-request rows a scalar loop would append."""
        category = int(category)
        level = int(level)
        lat = np.asarray(latencies_s, np.float64).ravel()
        uarr = np.asarray(us, np.float64).ravel()
        n = int(lat.size)
        if n == 0:
            return
        rec = self.recorder(level, category)
        self._c_requests.inc(n)
        if cached:
            self._c_cached.inc(n)
        rec.level_counter.inc(n)
        rec.lat_hist.record_many(lat * 1e3)
        rec.u_hist.record_many(uarr)
        cached = bool(cached)
        t_done = float(t_done)
        self.requests.extend(
            {"category": category, "latency_s": float(lat[i]),
             "u": int(uarr[i]), "cached": cached, "level": level,
             "t_done": t_done}
            for i in range(n))
        self._summary_dirty = True

    def record_queue_wait(self, *, category: int, level: int,
                          wait_s: float) -> None:
        """Admission-to-drain wait — the slice of latency the batcher
        owns, recorded separately so the SLO loop can tell queueing
        pressure from execution cost."""
        self.recorder(int(level), int(category)).qwait_hist.record(
            wait_s * 1e3)

    def record_batch(self, *, category: int, bucket: int, n_real: int,
                     t_inputs_s: float, t_execute_s: float) -> None:
        self.batches.append({
            "category": int(category),
            "bucket": int(bucket),
            "n_real": int(n_real),
            "n_padded": int(bucket - n_real),
            "t_inputs_s": float(t_inputs_s),
            "t_execute_s": float(t_execute_s),
        })
        self._summary_dirty = True

    def record_rejection(self, n: int = 1) -> None:
        self._c_rejected.inc(n)
        self._summary_dirty = True

    def observe_gauges(self, queue_depth: int, inflight: int) -> None:
        self._g_queue_depth.set(int(queue_depth))
        self._g_inflight.set(int(inflight))
        self._summary_dirty = True

    # ------------------------------------------------------------ summary
    def summary(self, compile_count: int = 0) -> Dict[str, float]:
        """Aggregate view; computed once per dirty window.  Repeated
        calls between records return a copy of the cached dict instead
        of re-running the O(window) percentile pass each time."""
        if (not self._summary_dirty and self._summary_cache is not None
                and self._summary_compile_count == int(compile_count)):
            out = dict(self._summary_cache)
            out["level_counts"] = dict(self._summary_cache["level_counts"])
            return out
        out = self._compute_summary(compile_count)
        self._summary_cache = out
        self._summary_compile_count = int(compile_count)
        self._summary_dirty = False
        return dict(out, level_counts=dict(out["level_counts"]))

    def _compute_summary(self, compile_count: int = 0) -> Dict[str, float]:
        lat = np.array([r["latency_s"] for r in self.requests], np.float64)
        us = np.array([r["u"] for r in self.requests], np.float64)
        cached = np.array([r["cached"] for r in self.requests], bool)
        span = ((self.requests[-1]["t_done"] - self.requests[0]["t_done"])
                if len(self.requests) >= 2 else 0.0)
        lanes = sum(b["bucket"] for b in self.batches)
        padded = sum(b["n_padded"] for b in self.batches)
        return {
            "n_requests": self.total_requests,
            "n_rejected": self.rejected,
            "n_batches": len(self.batches),
            "n_cached": self.total_cached,
            "cache_hit_rate": float(cached.mean()) if len(cached) else 0.0,
            "qps": (len(self.requests) / span) if span > 0 else 0.0,
            "latency_p50_ms": _pct(lat, 0.50) * 1e3,
            "latency_p99_ms": _pct(lat, 0.99) * 1e3,
            "latency_mean_ms": float(lat.mean()) * 1e3 if len(lat) else 0.0,
            "mean_u": float(us.mean()) if len(us) else 0.0,
            "p99_u": _pct(us, 0.99),
            "padding_overhead": (padded / lanes) if lanes else 0.0,
            "level_counts": dict(sorted(self.level_counts.items())),
            "compile_count": int(compile_count),
            "queue_depth": self.queue_depth,
            "inflight": self.inflight,
            "peak_queue_depth": self.peak_queue_depth,
            "peak_inflight": self.peak_inflight,
        }
