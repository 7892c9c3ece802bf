"""Unified metrics plane: counters, gauges, fixed-bucket histograms.

Host only (a copy of the reference's ``obs/metrics.py``, so that the
port imports nothing of the JAX package).

Every serving layer used to keep its own ad-hoc counts (`Telemetry`'s
ints, `AdmissionController.level_counts`, router pick tallies) and
`ClusterStats` stitched them together with per-layer dict math.  The
:class:`MetricsRegistry` replaces that with one vocabulary:

- **Counter** — monotone event count (requests served, cache hits).
- **Gauge** — a level that goes up and down (queue depth, reserved u);
  the peak since construction rides along.
- **Histogram** — fixed-bucket distribution (per-(level, category)
  latency / u / queue-wait); fixed edges make snapshots mergeable by
  elementwise addition, which quantile-deque windows are not.

Recording is lock-cheap: each instrument carries its own uncontended
lock (most instruments are written by exactly one thread — the replica
worker for serve metrics, the trainer thread for trainer metrics — so
acquisition never blocks), and hot paths hold instrument *handles*
instead of re-resolving ``(name, labels)`` per event.

``snapshot()`` returns a plain-dict, JSON-serializable view, and
``merge()`` folds any number of snapshots associatively — counters and
histogram buckets add, gauges take the max (a fleet's merged queue
depth is its hottest replica), so cluster-level stats are a fold over
replica snapshots and, later, over *process* snapshots shipped as JSON.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "metric_key", "merge_snapshots"]


def metric_key(name: str, labels: Mapping[str, object]) -> str:
    """Stable string key for (name, labels) — the snapshot/JSON key.
    Labels are sorted so construction order never changes the key."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone event counter."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """A level that moves both ways; remembers its peak.

    ``agg`` declares how replicas' snapshots of this gauge fold in
    ``merge_snapshots``: ``"max"`` (default) answers "how hot is the
    hottest replica" — right for saturation gauges like reserved u —
    while ``"sum"`` answers "how much is pending fleet-wide" — right
    for depth gauges, where max-of-replicas undercounts capacity math
    by a factor of N.  The tag rides the snapshot so merging stays a
    pure fold over JSON.
    """

    __slots__ = ("_lock", "value", "max", "agg")

    def __init__(self, agg: str = "max"):
        if agg not in ("max", "sum"):
            raise ValueError(f"gauge agg must be 'max' or 'sum', got {agg!r}")
        self._lock = threading.Lock()
        self.value = 0.0
        self.max = 0.0
        self.agg = agg

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value, "max": self.max,
                "agg": self.agg}


class Histogram:
    """Fixed-bucket histogram: ``edges`` are the finite upper bounds of
    the first ``len(edges)`` buckets, plus an implicit +inf overflow
    bucket — ``counts`` has ``len(edges) + 1`` entries.  Sum/count/min/
    max ride along so means survive merging exactly."""

    __slots__ = ("_lock", "edges", "counts", "sum", "count", "min", "max")

    def __init__(self, edges: Sequence[float]):
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram edges must be sorted, got {edges!r}")
        self._lock = threading.Lock()
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def record(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def record_many(self, values) -> None:
        """Record a batch of observations under ONE lock acquisition.

        Bucketing matches :meth:`record` exactly —
        ``np.searchsorted(edges, v, side="left")`` is
        ``bisect.bisect_left`` elementwise — so a slab recorded here is
        indistinguishable from a loop of scalar records."""
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.edges), v, side="left")
        binned = np.bincount(idx, minlength=len(self.edges) + 1)
        vmin = float(v.min())
        vmax = float(v.max())
        vsum = float(v.sum())
        n = int(v.size)
        with self._lock:
            for i in np.nonzero(binned)[0]:
                self.counts[int(i)] += int(binned[i])
            self.sum += vsum
            self.count += n
            if self.min is None or vmin < self.min:
                self.min = vmin
            if self.max is None or vmax > self.max:
                self.max = vmax

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the bucket holding
        the q-th observation) — coarse by design; exact percentiles
        come from `Telemetry`'s sliding window, this one is for merged
        fleet views where no window exists."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.edges[i] if i < len(self.edges) else self.max
        return self.max if self.max is not None else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "histogram", "edges": list(self.edges),
                    "counts": list(self.counts), "sum": self.sum,
                    "count": self.count, "min": self.min, "max": self.max}


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named, labeled instruments with a mergeable JSON snapshot.

    ``counter/gauge/histogram(name, **labels)`` get-or-create and
    return the instrument — callers on hot paths should hold the
    returned handle rather than re-resolving per event.  A name must
    keep one type and (for histograms) one edge layout for its
    lifetime; mismatches raise rather than silently fork the metric.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, object]" = {}

    def _get(self, cls, name: str, labels: dict, *args):
        key = metric_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(*args)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {key!r} is a "
                                f"{type(m).__name__}, not a {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, agg: str = "max", **labels) -> Gauge:
        g = self._get(Gauge, name, labels, agg)
        if g.agg != agg:
            raise ValueError(f"gauge {metric_key(name, labels)!r} already "
                             f"registered with agg={g.agg!r}, not {agg!r}")
        return g

    def histogram(self, name: str, edges: Sequence[float],
                  **labels) -> Histogram:
        h = self._get(Histogram, name, labels, edges)
        if h.edges != tuple(float(e) for e in edges):
            raise ValueError(f"histogram {metric_key(name, labels)!r} "
                             f"already registered with different edges")
        return h

    def collect(self, name: str) -> Dict[str, object]:
        """Instruments whose key starts with ``name`` (exact name or
        any labeling of it) — for summary aggregations."""
        with self._lock:
            return {k: m for k, m in self._metrics.items()
                    if k == name or k.startswith(name + "{")}

    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable view of every instrument."""
        with self._lock:
            metrics = dict(self._metrics)
        return {k: m.snapshot() for k, m in sorted(metrics.items())}


def _merge_two(a: dict, b: dict) -> dict:
    if a["type"] != b["type"]:
        raise ValueError(f"cannot merge {a['type']} with {b['type']}")
    if a["type"] == "counter":
        return {"type": "counter", "value": a["value"] + b["value"]}
    if a["type"] == "gauge":
        agg = a.get("agg", "max")
        if agg != b.get("agg", "max"):
            raise ValueError(f"cannot merge gauge agg={agg!r} with "
                             f"agg={b.get('agg', 'max')!r}")
        if agg == "sum":
            # Fleet-wide level: depth gauges add across replicas (the
            # per-replica peaks add too — an upper bound on the worst
            # co-occurring fleet level, not an observed instant).
            return {"type": "gauge", "value": a["value"] + b["value"],
                    "max": a["max"] + b["max"], "agg": "sum"}
        # max: a merged gauge answers "how hot is the hottest replica",
        # which is the admission/routing question
        return {"type": "gauge", "value": max(a["value"], b["value"]),
                "max": max(a["max"], b["max"]), "agg": "max"}
    if a["edges"] != b["edges"]:
        raise ValueError("cannot merge histograms with different edges")
    mins = [m for m in (a["min"], b["min"]) if m is not None]
    maxs = [m for m in (a["max"], b["max"]) if m is not None]
    return {"type": "histogram", "edges": list(a["edges"]),
            "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
            "sum": a["sum"] + b["sum"], "count": a["count"] + b["count"],
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None}


def merge_snapshots(snapshots: Iterable[Dict[str, dict]]) -> Dict[str, dict]:
    """Associative, commutative fold over registry snapshots: counters
    and histograms add, gauges take the max (or the sum, when declared
    ``agg="sum"`` — depth gauges).  ``ClusterStats`` is this fold over
    replica snapshots; the multi-process fleet is the same fold over
    JSON shipped across the IPC seam."""
    out: Dict[str, dict] = {}
    for snap in snapshots:
        for key, m in snap.items():
            out[key] = _merge_two(out[key], m) if key in out else dict(m)
    return dict(sorted(out.items()))
