"""Flight recorder: bounded structured event ring + postmortem bundles.

Metrics say *how much* and traces say *where the time went*; neither
answers "what was the cell DOING around the crash".  The
:class:`EventLog` records the fleet's state transitions — policy
publishes, index epoch swaps, merges, service-level transitions,
worker restarts, sheds with reason — as bounded structured events in
the same vocabulary the metrics registry uses (each kind also bumps an
``events.recorded{kind=...}`` counter when a registry is attached), so
the tail is cheap to keep forever and cheap to dump.

The :class:`FlightRecorder` owns one event log plus the static run
config and writes **postmortem bundles**: a single JSON file with the
event-ring tail, the last metrics snapshot, the trace tail, and
whatever the caller adds — written by ``ProcessReplica`` whenever it
salvages a dead worker, so a SIGKILL'd replica leaves forensics behind
instead of just a respawn counter.  The port's copy of the reference's
``obs/events.py``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["EventLog", "FlightRecorder"]


class EventLog:
    """Bounded ring of structured fleet events.

    ``record(kind, **fields)`` is lock-cheap and never grows past
    ``capacity`` — old events fall off the back, which is the point: a
    postmortem needs the *recent* history.  Events carry both clocks:
    ``t`` (``time.monotonic``, orderable against heartbeats) and
    ``t_wall`` (``time.time``, readable in a bundle).
    """

    def __init__(self, capacity: int = 4096, registry=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._registry = registry
        self._counters: Dict[str, object] = {}
        self.n_recorded = 0

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def n_evicted(self) -> int:
        return self.n_recorded - len(self._ring)

    def record(self, kind: str, **fields) -> dict:
        ev = {"t": time.monotonic(), "t_wall": time.time(),
              "kind": str(kind), **fields}
        with self._lock:
            self._ring.append(ev)
            self.n_recorded += 1
        if self._registry is not None:
            c = self._counters.get(kind)
            if c is None:
                c = self._counters[kind] = self._registry.counter(
                    "events.recorded", kind=kind)
            c.inc()
        return ev

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """The most recent ``n`` events (all, when None), oldest first."""
        with self._lock:
            events = list(self._ring)
        return events if n is None else events[-int(n):]

    def snapshot(self) -> List[dict]:
        return self.tail(None)


class FlightRecorder:
    """Event log + run config + a bundle directory = crash forensics.

    ``dump(name, payload)`` writes ``<bundle_dir>/<name>-NNN.json``
    holding the event-ring tail, the static config, and the caller's
    payload (metrics snapshot, trace tail, death traceback…).  With no
    ``bundle_dir`` the recorder still collects events but ``dump`` is a
    no-op returning None — the thread backend records transitions
    without ever writing bundles.
    """

    #: Bounds on what one bundle carries — a postmortem wants the tail,
    #: not the life story.
    EVENTS_TAIL = 256
    TRACE_TAIL = 512

    def __init__(self, events: Optional[EventLog] = None,
                 bundle_dir=None, config: Optional[dict] = None):
        self.events = events if events is not None else EventLog()
        self.bundle_dir = Path(bundle_dir) if bundle_dir else None
        self.config = config or {}
        self._lock = threading.Lock()
        self._seq = 0
        self.last_bundle_path: Optional[Path] = None

    def record(self, kind: str, **fields) -> dict:
        return self.events.record(kind, **fields)

    def dump(self, name: str, payload: Optional[dict] = None):
        """Write one postmortem bundle; returns its path (None when no
        bundle dir is configured)."""
        if self.bundle_dir is None:
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
        bundle = {
            "bundle": name,
            "seq": seq,
            "t_wall": time.time(),
            "config": self.config,
            "events_tail": self.events.tail(self.EVENTS_TAIL),
            "events_recorded": self.events.n_recorded,
        }
        if payload:
            trace = payload.get("trace_tail")
            if trace is not None:
                payload = {**payload,
                           "trace_tail": list(trace)[-self.TRACE_TAIL:]}
            bundle.update(payload)
        self.bundle_dir.mkdir(parents=True, exist_ok=True)
        path = self.bundle_dir / f"{name}-{seq:03d}.json"
        path.write_text(json.dumps(bundle, indent=1, default=str))
        with self._lock:
            self.last_bundle_path = path
        return path
