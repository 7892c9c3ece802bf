"""Ticket-scoped tracing: spans from admission to kernel, exportable
to Perfetto.

The port's copy of the reference's ``obs/trace.py``, as far as one
process uses it: :class:`Span`, :data:`NULL_SPAN`, :class:`TraceLog`,
:class:`Tracer`, :data:`NULL_TRACER` and the Chrome export.  A query's
latency is spent across admission, queueing, batch assembly and the
serve step on the device; the engine records that path as a tree of
spans, one Perfetto row (*track*) per ticket:

    ticket #17 qid=42            ──────────────────────────────
      submit                     ─
      queue                       ───────
      batch                              ──
      execute                              ────────
      respond                                      ─

Thread-level work (micro-batches, serve-step preparations) lands on the
owning thread's track.  Everything shares one clock
(``time.perf_counter`` unless the tracer is given another).

Code that takes no tracer argument (the rule loop in ``core/``) traces
under the *active* tracer: a caller sets one for a block with
:func:`tracing`, and :func:`scope` opens a span under the innermost
open one there.  The state is a ``contextvar``, so each thread sees only
the tracer its own caller set.  :func:`host_sync` marks a blocking
device→host read: it counts it (:func:`host_syncs`, always on) and,
under an active tracer, times it as a ``sync`` span.  :func:`collective`
marks one collective of ``distributed/collectives.py`` the same way: a
count (:func:`collectives`, always on) and, under an active tracer, a
``collective`` span with the op, the mesh axis and the bytes this rank
puts in.

Multi-process cells merge several logs into one timeline: each worker
ships entry deltas (:meth:`TraceLog.drain_since`) over its control
pipe, the parent rebases them onto its own clock and id space
(:func:`adjust_remote_entries` — the offset comes from a ping handshake
at worker startup), and :func:`export_chrome_entries` namespaces tracks
by (pid, track) so worker threads from different processes never share
a tid.  Entries whose track is a ticket track (``ticket #<id>``) keep
the parent's pid — the worker-side execute/respond spans land on the
SAME Perfetto row as the parent's admit/ring spans.  Residual
clock-offset error is absorbed at export by clamping a shipped span to
the bounds of the span that encloses it on its track, so B/E stacks
nest by construction no matter how skewed the estimate was.

Cost model: tracing is **off by default** — a disabled tracer returns
the ``NULL_SPAN`` singleton from every call, so instrumentation costs
one attribute check per site.  Enabled, spans are plain ``__slots__``
objects appended to a bounded ring (:class:`TraceLog`) *when they end*;
nothing is serialized until :meth:`TraceLog.export_chrome`.

Export is the Chrome trace-event JSON flavor Perfetto loads directly
(``ui.perfetto.dev`` → Open trace file): sorted, matched B/E duration
events plus ``i`` instants, with per-track ``thread_name`` metadata.
Ring eviction drops oldest-ended spans first; because a parent always
ends after its children, eviction can orphan a surviving span's
``parent_id`` — :meth:`TraceLog.snapshot` re-roots those instead of
exporting dangling ids.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Span", "TraceLog", "Tracer", "NULL_SPAN", "NULL_TRACER",
           "active", "tracing", "scope", "host_sync", "host_syncs",
           "collective", "collectives",
           "adjust_remote_entries", "export_chrome_entries",
           "write_chrome_entries"]

#: Track-name prefix of per-ticket rows (``Tracer.root_span("ticket")``
#: makes ``ticket #<id>``); merged remote entries on these tracks join
#: the parent process's row instead of opening a per-worker one.
TICKET_TRACK_PREFIX = "ticket #"


class Span:
    """One timed operation.  Create via ``Tracer.span``/``root_span``
    or ``Span.child``; close with :meth:`end` (or use as a context
    manager).  The record enters the trace ring only at ``end``."""

    __slots__ = ("_tracer", "name", "track", "span_id", "parent_id",
                 "t0", "t1", "args")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 span_id: int, parent_id: Optional[int], t0: float,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.args = args

    def __bool__(self) -> bool:
        return True

    def child(self, name: str, **args) -> "Span":
        """A child span on this span's track, starting now."""
        return self._tracer.span(name, track=self.track,
                                 parent=self, **args)

    def child_at(self, name: str, t0: float, t1: float, **args) -> "Span":
        """A retroactive, already-finished child for work whose
        boundaries were measured before the span objects existed
        (per-lane views of a batch execution)."""
        return self._tracer.span_at(name, t0, t1, track=self.track,
                                    parent=self, **args)

    def instant(self, name: str, **args) -> None:
        self._tracer.instant(name, track=self.track, parent=self, **args)

    def end(self, t1: Optional[float] = None, **args) -> None:
        if self.t1 is not None:        # double-end: keep the first
            return
        self.t1 = self._tracer.clock() if t1 is None else t1
        if args:
            self.args = {**(self.args or {}), **args}
        self._tracer.log.append_span(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.end(error=exc_type.__name__) if exc_type else self.end()


class _NullSpan:
    """Inert stand-in returned by a disabled tracer: every method
    no-ops, children are itself, truthiness is False so callers can
    gate optional work with ``if span:``."""

    __slots__ = ()
    name = track = ""
    span_id = parent_id = t0 = t1 = args = None

    def __bool__(self) -> bool:
        return False

    def child(self, name, **args) -> "_NullSpan":
        return self

    def child_at(self, name, t0, t1, **args) -> "_NullSpan":
        return self

    def instant(self, name, **args) -> None:
        pass

    def end(self, t1=None, **args) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class TraceLog:
    """Bounded ring of finished spans + instant events.

    Entries are appended in end-time order, so eviction drops the
    oldest-*ended* work first; a parent (which ends after its children)
    therefore always outlives its children in the ring, and the only
    dangling edge eviction can create is a surviving span whose
    ``parent_id`` left the ring — ``snapshot()`` re-roots those.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self.n_recorded = 0

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def n_evicted(self) -> int:
        return self.n_recorded - len(self._ring)

    def append_span(self, span: Span) -> None:
        with self._lock:
            self._ring.append(("span", span.name, span.track, span.span_id,
                               span.parent_id, span.t0, span.t1, span.args))
            self.n_recorded += 1

    def append_instant(self, name: str, track: str, t: float,
                       parent_id: Optional[int], args: Optional[dict]) -> None:
        with self._lock:
            self._ring.append(("instant", name, track, None, parent_id,
                               t, t, args))
            self.n_recorded += 1

    # ---------------------------------------------------------- export
    def snapshot(self) -> List[dict]:
        """Finished entries as dicts, oldest first, with parent ids
        that left the ring re-rooted to None (no dangling references
        survive into an export)."""
        with self._lock:
            entries = list(self._ring)
        live = {e[3] for e in entries if e[3] is not None}
        return [{"kind": kind, "name": name, "track": track, "id": sid,
                 "parent": parent if parent in live else None,
                 "t0": t0, "t1": t1, "args": args}
                for kind, name, track, sid, parent, t0, t1, args in entries]

    def drain_since(self, cursor: int) -> Tuple[List[dict], int]:
        """Entries recorded after ``cursor`` (a previous return's new
        cursor; 0 for everything), as snapshot-shaped dicts.  The
        worker→parent shipping primitive: each control-pipe stats reply
        carries only the delta, and entries the ring already evicted
        are silently skipped (the parent's tail is best-effort by
        design).  Parent ids are NOT re-rooted here — earlier deltas
        may hold the parent; the exporter re-roots whatever is still
        dangling at merge time."""
        with self._lock:
            total = self.n_recorded
            ring = list(self._ring)
        start = max(int(cursor), total - len(ring))
        entries = ring[len(ring) - (total - start):] if start < total else []
        return ([{"kind": kind, "name": name, "track": track, "id": sid,
                  "parent": parent, "t0": t0, "t1": t1, "args": args}
                 for kind, name, track, sid, parent, t0, t1, args in entries],
                total)

    def export_chrome(self, process_name: str = "repro_torch") -> dict:
        """Chrome trace-event JSON (Perfetto-loadable) of this log's
        entries — see :func:`export_chrome_entries`."""
        return export_chrome_entries(self.snapshot(),
                                     process_name=process_name)

    def write_chrome(self, path, process_name: str = "repro_torch") -> None:
        write_chrome_entries(path, self.snapshot(),
                             process_name=process_name)


# ---------------------------------------------------------------- merge
def adjust_remote_entries(entries: Iterable[dict], *, dt: float = 0.0,
                          id_offset: int = 0, pid: Optional[int] = None,
                          ticket_args: Optional[dict] = None) -> List[dict]:
    """Rebase another process's trace entries into the local timeline.

    - ``dt`` shifts every timestamp onto the local clock (local ≈
      remote + dt, estimated from the ping handshake's min-RTT sample);
    - ``id_offset`` moves span/parent ids into a per-worker range so
      two processes' independent id counters can't collide;
    - entries on ticket tracks (``ticket #<id>``) stay pid-less — they
      join the parent's Perfetto row under the parent-side ring span —
      and pick up ``ticket_args`` (e.g. ``{"wpid": 1234}``) so the
      chain checker can count worker pids; every other track is stamped
      with ``pid`` and becomes its own (pid, track) row at export.
    """
    out = []
    for e in entries:
        e = dict(e)
        e["t0"] = e["t0"] + dt
        if e["t1"] is not None:
            e["t1"] = e["t1"] + dt
        if e["id"] is not None:
            e["id"] = e["id"] + id_offset
        if e["parent"] is not None:
            e["parent"] = e["parent"] + id_offset
        if e["track"].startswith(TICKET_TRACK_PREFIX):
            if ticket_args:
                e["args"] = {**(e["args"] or {}), **ticket_args}
        elif pid is not None:
            e["pid"] = pid
        out.append(e)
    return out


def _clamp_nesting(entries: List[dict]) -> None:
    """Clamp partially-overlapping spans per (pid, track) so B/E events
    nest.  Cross-process spans are aligned by an *estimated* clock
    offset; the residual error can push a shipped span past the bounds
    of the span that logically encloses it.  Snapping the child into
    the enclosing span's window keeps every track a proper tree without
    reordering — the invariant check_trace.py asserts.

    Each span is also stamped with its stack depth (``_depth``).
    Clamping routinely makes a child share its parent's exact boundary,
    and at equal timestamps only containment can order the B/E events —
    the exporter breaks those ties with the depth (deepest E closes
    first, shallowest B opens first)."""
    by_track: Dict[tuple, List[dict]] = {}
    for e in entries:
        if e["kind"] == "span":
            by_track.setdefault((e.get("pid"), e["track"]), []).append(e)
    for spans in by_track.values():
        # At equal t0 the longer span is the parent; it must sort first.
        spans.sort(key=lambda e: (e["t0"], -(e["t1"] - e["t0"])))
        stack: List[dict] = []
        for e in spans:
            while stack and stack[-1]["t1"] <= e["t0"]:
                stack.pop()
            if stack:
                top = stack[-1]
                if e["t0"] < top["t0"]:
                    e["t0"] = top["t0"]
                if e["t1"] > top["t1"]:
                    e["t1"] = top["t1"]
                if e["t1"] < e["t0"]:
                    e["t1"] = e["t0"]
            e["_depth"] = len(stack)
            stack.append(e)


def export_chrome_entries(entries: Iterable[dict],
                          process_name: str = "repro_torch",
                          pid_names: Optional[Dict[int, str]] = None) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable) from snapshot-shaped
    entries, possibly merged from several processes.

    Every span becomes a matched B/E pair; instants become ``i``
    events.  Events are sorted by timestamp with closes before opens at
    equal ts, so per-tid B/E stacks nest by construction.  Timestamps
    are µs from the earliest entry.

    Entries may carry an optional ``pid`` (absent/None = the exporting
    process, emitted as pid 1).  Tids are assigned per **(pid, track)**
    — worker threads from different processes never share a tid even
    when their thread names collide — and each pid gets its own
    ``process_name`` metadata row (``pid_names`` overrides the default
    ``<process_name>/pid <pid>`` label)."""
    entries = [dict(e) if e["kind"] == "span" else e for e in entries]
    _clamp_nesting(entries)
    # Deltas shipped ring-by-ring can strand a parent id whose entry
    # was evicted remotely — re-root those like TraceLog.snapshot does.
    live = {e["id"] for e in entries if e["id"] is not None}

    tids: Dict[tuple, int] = {}
    for e in entries:
        tids.setdefault((e.get("pid"), e["track"]), len(tids) + 1)
    t_min = min((e["t0"] for e in entries), default=0.0)
    us = lambda t: (t - t_min) * 1e6

    events = []
    # priority orders equal-ts events: E closes before i, i before
    # B opens — adjacent spans sharing a boundary still nest.  Within a
    # priority class, clamp depth breaks the tie: a clamped child shares
    # its parent's exact boundary, where only containment can order the
    # events — the deepest E closes first, the shallowest B opens first.
    for e in entries:
        pid = e.get("pid") or 1
        tid = tids[(e.get("pid"), e["track"])]
        args = e["args"] or {}
        depth = e.get("_depth", 0)
        if e["parent"] is not None and e["parent"] in live:
            args = {**args, "parent_span": e["parent"]}
        if e["kind"] == "instant":
            events.append((us(e["t0"]), 1, 0, {
                "name": e["name"], "ph": "i", "s": "t",
                "ts": us(e["t0"]), "pid": pid, "tid": tid, "args": args}))
        else:
            common = {"name": e["name"], "pid": pid, "tid": tid}
            if e["id"] is not None:
                args = {**args, "span_id": e["id"]}
            events.append((us(e["t0"]), 2, depth, {
                **common, "ph": "B", "ts": us(e["t0"]), "args": args}))
            events.append((us(e["t1"]), 0, -depth, {
                **common, "ph": "E", "ts": us(e["t1"])}))
    events.sort(key=lambda ev: ev[:3])

    pids = sorted({p for p, _track in tids}, key=lambda p: (p is not None, p))
    meta = []
    for p in pids:
        emitted = p or 1
        name = (process_name if p is None
                else (pid_names or {}).get(p, f"{process_name}/pid {p}"))
        meta.append({"name": "process_name", "ph": "M", "ts": 0,
                     "pid": emitted, "tid": 0, "args": {"name": name}})
    for (p, track), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        emitted = p or 1
        meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                     "pid": emitted, "tid": tid, "args": {"name": track}})
        meta.append({"name": "thread_sort_index", "ph": "M", "ts": 0,
                     "pid": emitted, "tid": tid,
                     "args": {"sort_index": tid}})
    return {"traceEvents": meta + [ev for *_, ev in events],
            "displayTimeUnit": "ms"}


def write_chrome_entries(path, entries: Iterable[dict],
                         process_name: str = "repro_torch",
                         pid_names: Optional[Dict[int, str]] = None) -> None:
    from pathlib import Path
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(export_chrome_entries(
        entries, process_name=process_name, pid_names=pid_names)))


class Tracer:
    """Span factory over one :class:`TraceLog` and one clock.

    ``enabled=False`` (the serving default) makes every factory method
    return :data:`NULL_SPAN` / no-op after a single attribute check —
    the off-path cost the serve_bench obs-overhead section pins down.
    """

    def __init__(self, log: Optional[TraceLog] = None, enabled: bool = True,
                 clock=time.perf_counter):
        self.log = log if log is not None else TraceLog()
        self.enabled = bool(enabled)
        self.clock = clock
        self._ids = itertools.count(1)

    @staticmethod
    def _track(track: Optional[str], parent: Optional[Span]) -> str:
        if track is not None:
            return track
        if parent is not None and parent.track:
            return parent.track
        return threading.current_thread().name

    def span(self, name: str, track: Optional[str] = None,
             parent: Optional[Span] = None, **args) -> Span:
        if not self.enabled:
            return NULL_SPAN
        parent = parent or None       # NULL_SPAN parents read as None
        return Span(self, name, self._track(track, parent),
                    next(self._ids),
                    parent.span_id if parent else None,
                    self.clock(), args or None)

    def span_at(self, name: str, t0: float, t1: float,
                track: Optional[str] = None, parent: Optional[Span] = None,
                **args) -> Span:
        """Record an already-finished span from measured boundaries."""
        if not self.enabled:
            return NULL_SPAN
        parent = parent or None
        s = Span(self, name, self._track(track, parent), next(self._ids),
                 parent.span_id if parent else None, t0, args or None)
        s.end(t1=t1)
        return s

    def root_span(self, name: str, **args) -> Span:
        """A span opening its own unique track — one Perfetto row per
        ticket, so concurrent tickets never interleave B/E events."""
        if not self.enabled:
            return NULL_SPAN
        span_id = next(self._ids)
        return Span(self, name, f"{name} #{span_id}", span_id, None,
                    self.clock(), args or None)

    def instant(self, name: str, track: Optional[str] = None,
                parent: Optional[Span] = None, **args) -> None:
        if not self.enabled:
            return
        parent = parent or None
        self.log.append_instant(name, self._track(track, parent),
                                self.clock(),
                                parent.span_id if parent else None,
                                args or None)


#: Shared disabled tracer — the default everywhere a tracer is optional.
NULL_TRACER = Tracer(log=TraceLog(capacity=1), enabled=False)


# ------------------------------------------------------ the active tracer
#: (tracer, innermost open scope) of the running context.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_tracer", default=(NULL_TRACER, None))
_host_syncs = 0
_host_syncs_lock = threading.Lock()
_collectives = 0
_collectives_lock = threading.Lock()


def active() -> Tracer:
    """The tracer that a caller set with :func:`tracing` for the running
    context (thread); :data:`NULL_TRACER` where none did."""
    return _ACTIVE.get()[0]


@contextlib.contextmanager
def tracing(tracer: Tracer):
    """Make ``tracer`` the active tracer inside the block; the outermost
    spans that :func:`scope` opens there are roots on the calling
    thread's track."""
    token = _ACTIVE.set((tracer, None))
    try:
        yield tracer
    finally:
        _ACTIVE.reset(token)


class _Scope:
    """An open span of the active tracer that is the innermost one while
    its block runs."""

    __slots__ = ("span", "_token")

    def __init__(self, span: Span):
        self.span = span

    def __enter__(self) -> Span:
        self._token = _ACTIVE.set((self.span._tracer, self.span))
        return self.span

    def __exit__(self, exc_type, *exc) -> None:
        _ACTIVE.reset(self._token)
        self.span.__exit__(exc_type, *exc)


def scope(name: str, **args):
    """``with scope(name, **args) as span:`` a span of the active tracer,
    child of the innermost open scope and innermost itself until the
    block ends; ``span.end(**more)`` inside the block ends it early with
    more args.  With no tracer active: :data:`NULL_SPAN`, after one
    check."""
    tracer, parent = _ACTIVE.get()
    if not tracer.enabled:
        return NULL_SPAN
    return _Scope(tracer.span(name, parent=parent, **args))


def host_sync(site: str):
    """Mark one blocking device→host read at ``site``: ``with
    host_sync("cond_any"): go = bool(cond.any())``.  Counts it in a
    plain process-wide count (:func:`host_syncs`) and, under an active
    tracer, times it as a ``sync`` span.  A read on ``meta`` (a dry run)
    reads nothing: its site does not come here."""
    global _host_syncs
    with _host_syncs_lock:
        _host_syncs += 1
    return scope("sync", site=site)


def host_syncs() -> int:
    """The device→host reads marked with :func:`host_sync` in this
    process so far."""
    return _host_syncs


def collective(op: str, axis: str, nbytes: int):
    """Mark one collective over the mesh axis ``axis``: ``with
    collective("all_gather", "model", x.nbytes): dist.all_gather_into_tensor(
    ...)``.  Counts it in a plain process-wide count (:func:`collectives`)
    and, under an active tracer, times its host call as a ``collective``
    span (``op``, ``axis``, ``bytes``: what this rank puts in)."""
    global _collectives
    with _collectives_lock:
        _collectives += 1
    return scope("collective", op=op, axis=axis, bytes=int(nbytes))


def collectives() -> int:
    """The collectives marked with :func:`collective` in this process so
    far."""
    return _collectives
