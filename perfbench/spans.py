"""The program's own spans over a profiled slice: the clock that puts them
on the profiler's time line, and what is read from them beside the
device's activity.

The program records spans only under a tracer that its caller passes
(``repro_torch.obs.trace.tracing``): a ``rollout`` or ``train_batch``
span a call, with ``step``, ``act``, ``rule``, ``chunk``, ``sync``,
``reward``, ``stack``, ``td_update`` and ``metrics`` inside.  A tracer
made with ``clock=profiler_clock`` stamps them on the clock of
``torch.profiler``'s events, so that a span, a CUDA API call and a
device operation of one slice lie on one time line.  Spans are read
from the tracer's log (``TraceLog.snapshot()``) as :class:`Interval`
s in µs, the unit of ``trace._raw_events``.  Each reader returns None
where it finds nothing to read."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from perfbench import trace

LOOP = ("rollout", "train_batch")   # a call's outermost spans: the loop
SYNC = "sync"                       # a blocking device-to-host read
OUTSIDE = "outside"                 # idle time under no span


def profiler_clock() -> float:
    """Seconds on the clock of ``torch.profiler``'s event times: the Unix
    epoch, as ``time.time_ns`` reads it, which kineto's ``start_ns``
    carries (the test ``test_the_profiler_clock_holds_a_marker`` holds a
    span on this clock around a ``record_function`` marker)."""
    return time.time_ns() * 1e-9


@dataclasses.dataclass(frozen=True)
class Interval:
    name: str
    path: str           # names from the root down: rollout/step/rule
    start: float        # µs
    end: float

    @property
    def depth(self) -> int:
        return self.path.count("/")


def intervals(entries: Iterable[dict]) -> List[Interval]:
    """The finished spans of a ``TraceLog.snapshot()``, with their paths,
    in µs, by start."""
    spans = {e["id"]: e for e in entries if e["kind"] == "span"}

    def path(e):
        names = []
        while e is not None:
            names.append(e["name"])
            e = spans.get(e["parent"])
        return "/".join(reversed(names))

    return sorted((Interval(e["name"], path(e), 1e6 * e["t0"], 1e6 * e["t1"])
                   for e in spans.values()), key=lambda i: (i.start, -i.end))


def covering(spans: Sequence[Interval], t: float) -> Optional[Interval]:
    """The innermost span that holds the instant ``t`` (µs), or None."""
    inner = [i for i in spans if i.start <= t <= i.end]
    return max(inner, key=lambda i: (i.depth, i.start)) if inner else None


def _overlap(a: List[List[float]], b: List[List[float]]) -> float:
    """The length shared by two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(merged: List[List[float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The gaps between the device's merged busy intervals inside
    [start, end], in time order, as ``trace.idle_gaps`` finds them."""
    gaps, prev = [], start
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if end > prev:
        gaps.append((prev, end))
    return gaps


def sync_wait_share(spans: Sequence[Interval], window_s: float
                    ) -> Optional[float]:
    """100 x the union of the ``sync`` spans over the slice's wall time:
    the share of the slice in which the host waited on a read from the
    card."""
    syncs = [(i.start, i.end) for i in spans if i.name == SYNC]
    if not syncs or window_s <= 0.0:
        return None
    return 100.0 * trace.union_busy(syncs)[1] / (1e6 * window_s)


def loop_idle_share(spans: Sequence[Interval], merged: List[List[float]],
                    window_s: float) -> Optional[float]:
    """100 x the device's idle time inside the program's loop spans
    (``rollout``, ``train_batch``) over the slice's wall time: the idle
    time that the program's host work costs, not the caller's."""
    loops, length = trace.union_busy([(i.start, i.end) for i in spans
                                      if i.name in LOOP])
    if not loops or window_s <= 0.0:
        return None
    return 100.0 * (length - _overlap(loops, merged)) / (1e6 * window_s)


def idle_by_span(merged: List[List[float]], spans: Sequence[Interval],
                 start: float, end: float,
                 over: Sequence[Tuple[str, float, float]] = ()
                 ) -> Dict[str, float]:
    """The device's idle seconds inside [start, end] by the innermost
    span over them (``OUTSIDE`` under none).  Each (name, start, end) of
    ``over`` (host events such as the profiler's own buffer requests)
    takes its time from whatever span it lies in."""
    marks = []          # (µs, order, +1 open / -1 close, depth, name)
    for s, e in idle(merged, start, end):
        marks += [(s, 1, 1, None, None), (e, 0, -1, None, None)]
    for i in spans:
        marks += [(i.start, 1, 1, i.depth, i.name),
                  (i.end, 0, -1, i.depth, i.name)]
    for name, s, e in over:
        marks += [(s, 1, 1, float("inf"), name),
                  (e, 0, -1, float("inf"), name)]
    marks.sort(key=lambda m: (m[0], m[1]))
    out: Dict[str, float] = {}
    open_: Dict[Tuple[float, str], int] = {}
    idle_open, prev = 0, None
    for t, _, step, depth, name in marks:
        if idle_open and prev is not None and t > prev:
            key = max(open_)[1] if open_ else OUTSIDE
            out[key] = out.get(key, 0.0) + (t - prev) / 1e6
        if name is None:
            idle_open += step
        else:
            k = (depth, name)
            open_[k] = open_.get(k, 0) + step
            if open_[k] == 0:
                del open_[k]
        prev = t
    return out


def idle_gaps(merged, host, start: float, end: float,
              spans: Optional[Sequence[Interval]] = None,
              top: int = trace.TOP):
    """``trace.idle_gaps`` with each gap that a span covers at its middle
    named ``<span path> · <the name trace.idle_gaps gives it>``; without
    spans, exactly ``trace.idle_gaps``."""
    if not spans:
        return trace.idle_gaps(merged, host, start, end, top)
    gaps = sorted(idle(merged, start, end), key=lambda g: g[1] - g[0],
                  reverse=True)
    out = []
    for s, e in gaps[:top]:
        name, seconds = trace.idle_gaps([], host, s, e, 1)[0]
        inner = covering(spans, 0.5 * (s + e))
        out.append((f"{inner.path} · {name}" if inner else name, seconds))
    return out
