"""Query routing across serving replicas (the port's copy of the
reference's ``cluster/router.py``; pure host code).

Round-robin is the strawman: it ignores both load (a replica stuck
behind an expensive CAT1 micro-batch keeps receiving its share while
neighbours idle) and locality (a hot navigational query lands on every
replica, paying one result-cache miss per replica instead of one per
fleet).  :class:`QueueAwareRouter` fixes both: a key the cluster has
routed before goes straight back to the replica whose result cache
owns it — the repeat is nearly free there — while a first-seen key
starts at its hash-preferred replica and spills to the least-loaded
one when the preferred depth (queued + inflight, the ``ServeEngine``
gauges) exceeds the minimum by more than ``spill_margin``.
"""
from __future__ import annotations

import itertools
import threading
import zlib
from typing import Optional, Sequence

from repro_torch.obs import MetricsRegistry

__all__ = ["stable_query_hash", "Router", "RoundRobinRouter",
           "QueueAwareRouter", "make_router"]


def stable_query_hash(key) -> int:
    """Process-independent hash of a canonical query key (cache
    affinity must survive restarts and not depend on PYTHONHASHSEED)."""
    return zlib.crc32(repr(key).encode())


class Router:
    """Protocol: pick a replica index for a request.

    ``pick(key_hash, depths, owner)`` sees the request's stable
    query-key hash, a per-replica depth snapshot, and — when the
    cluster has routed this key before — the replica whose result cache
    owns it.  Implementations must be thread-safe (the cluster may be
    fed from several submitter threads).
    """

    name: str = ""

    def pick(self, key_hash: int, depths: Sequence[int],
             owner: Optional[int] = None) -> int:
        raise NotImplementedError

    def wants_full_depths(self, owner_depth: int) -> bool:
        """Whether ``pick`` will need the whole fleet's depth snapshot
        for a request whose cache owner currently carries
        ``owner_depth`` units of work.  The cluster uses this to skip
        the per-replica gauge sweep on the sticky fast path; the rule
        lives HERE so it can never drift from ``pick``'s own
        sticky-vs-spill decision."""
        return False

    def stats(self) -> dict:
        return {"router": self.name}


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._counter = itertools.count()

    def pick(self, key_hash: int, depths: Sequence[int],
             owner: Optional[int] = None) -> int:
        return next(self._counter) % len(depths)


class QueueAwareRouter(Router):
    """Cache-owner-sticky, depth-balanced routing with owner-saturation
    spill.

    A key already routed somewhere goes back to that replica — its
    result cache makes the repeat nearly free, while a "balanced" miss
    elsewhere costs a full rollout — UNLESS the owner is saturated: a
    likely hit queued behind ``owner_spill_depth`` units of pending
    work pays the owner's whole backlog in latency, which is worse than
    one balanced-path rollout on an idle neighbour.  Saturated-owner
    requests therefore fall through to the depth-balanced path (and the
    cluster records the new pick as the key's owner, so the hot key's
    cache footprint migrates off the hot replica instead of feeding it).

    First-seen keys start from their hash-preferred replica and spill
    to the least-loaded one when the preferred queue is ``spill_margin``
    deeper; the cluster then records the pick as the key's owner.
    """

    name = "queue_aware"

    def __init__(self, spill_margin: int = 4,
                 owner_spill_depth: Optional[int] = 32,
                 registry: Optional[MetricsRegistry] = None):
        if spill_margin < 0:
            raise ValueError("spill_margin must be >= 0")
        if owner_spill_depth is not None and owner_spill_depth < 0:
            raise ValueError("owner_spill_depth must be >= 0 (or None)")
        self.spill_margin = spill_margin
        self.owner_spill_depth = owner_spill_depth
        self._lock = threading.Lock()
        self.affinity_picks = 0
        self.sticky_picks = 0
        self.spills = 0
        self.owner_spills = 0
        reg = registry if registry is not None else MetricsRegistry()
        self._pick_counters = {
            kind: reg.counter("router.picks", kind=kind)
            for kind in ("sticky", "affinity", "spill", "owner_spill")}

    def wants_full_depths(self, owner_depth: int) -> bool:
        return (self.owner_spill_depth is not None
                and owner_depth > self.owner_spill_depth)

    def pick(self, key_hash: int, depths: Sequence[int],
             owner: Optional[int] = None) -> int:
        n = len(depths)
        avoid = None
        if owner is not None and 0 <= owner < n:
            if not self.wants_full_depths(depths[owner]):
                with self._lock:
                    self.sticky_picks += 1
                self._pick_counters["sticky"].inc()
                return owner
            # saturated owner: a likely hit is not worth its backlog —
            # fall through to the depth-balanced first-seen path
            with self._lock:
                self.owner_spills += 1
            self._pick_counters["owner_spill"].inc()
            avoid = owner
        pref = key_hash % n
        best = min(range(n), key=depths.__getitem__)
        if avoid is not None and pref == avoid:
            # the hash-preferred replica IS the saturated owner; going
            # back there would make the spill a no-op (unless the whole
            # fleet is even deeper, in which case best == owner and the
            # owner genuinely is the least bad choice) — counted as a
            # spill so stats' pick total stays complete
            with self._lock:
                self.spills += 1
            self._pick_counters["spill"].inc()
            return best
        if depths[pref] - depths[best] > self.spill_margin:
            with self._lock:
                self.spills += 1
            self._pick_counters["spill"].inc()
            return best
        with self._lock:
            self.affinity_picks += 1
        self._pick_counters["affinity"].inc()
        return pref

    def stats(self) -> dict:
        total = self.affinity_picks + self.sticky_picks + self.spills
        return {
            "router": self.name,
            "spill_margin": self.spill_margin,
            "owner_spill_depth": self.owner_spill_depth,
            "affinity_picks": self.affinity_picks,
            "sticky_picks": self.sticky_picks,
            "spills": self.spills,
            "owner_spills": self.owner_spills,
            "spill_rate": self.spills / total if total else 0.0,
        }


def make_router(name: str, spill_margin: int = 4,
                owner_spill_depth: Optional[int] = 32,
                registry: Optional[MetricsRegistry] = None) -> Router:
    if name == "round_robin":
        return RoundRobinRouter()
    if name == "queue_aware":
        return QueueAwareRouter(spill_margin=spill_margin,
                                owner_spill_depth=owner_spill_depth,
                                registry=registry)
    raise ValueError(
        f"unknown routing policy {name!r}; available: "
        "('queue_aware', 'round_robin')")
