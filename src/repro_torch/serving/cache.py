"""LRU result cache for the online serving engine.

Keys are canonicalized query term sets (category, sorted unique valid
term ids) so syntactic duplicates — repeated hot navigational queries,
the head of the Zipf popularity curve — hit the same entry regardless
of term order or padding.  Values are fully materialized host-side
responses (doc ids, L1 scores, u), so a hit bypasses occupancy
gathering, the rollout, and L1 pruning entirely.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Optional, Tuple

import numpy as np

from repro_torch.obs import Counter, MetricsRegistry

__all__ = ["canonical_query_key", "versioned_key", "LRUResultCache"]


def canonical_query_key(terms, category: int) -> Tuple[int, Tuple[int, ...]]:
    """(category, sorted deduped valid term ids) — padding (-1) stripped."""
    t = np.asarray(terms).ravel()
    t = t[t >= 0]
    return (int(category), tuple(sorted({int(x) for x in t})))


def versioned_key(base_key: Hashable, policy_version: int,
                  index_epoch: int) -> Tuple[Hashable, int, int]:
    """Full cache key: a cached response embodies BOTH the policy
    snapshot that rolled it out and the index epoch it scanned, so the
    entry key carries both versions.  A policy publish or an index
    epoch swap then invalidates exactly the stale entries — the new
    version simply never looks them up — without flushing results that
    are still current on the other axis.  Static systems pass
    ``index_epoch=0`` forever and the scheme degrades to per-policy
    keying."""
    return (base_key, int(policy_version), int(index_epoch))


class LRUResultCache:
    """Plain OrderedDict LRU with hit/miss accounting.

    ``capacity <= 0`` disables caching (every lookup is a miss), which
    keeps the engine's control flow identical with and without a cache.
    """

    def __init__(self, capacity: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        # With a registry, the counters land in the shared metrics
        # plane (mergeable across replicas, visible in --metrics-json);
        # standalone caches get private instruments.  Either way the
        # hits/misses/evictions attributes below read through.
        reg = registry.counter if registry is not None else (
            lambda name: Counter())
        self._hits = reg("cache.hits")
        self._misses = reg("cache.misses")
        self._evictions = reg("cache.evictions")

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Hashable) -> Optional[Any]:
        if self.capacity > 0 and key in self._entries:
            self._entries.move_to_end(key)
            self._hits.inc()
            return self._entries[key]
        self._misses.inc()
        return None

    def contains(self, key: Hashable) -> bool:
        """Membership probe without touching LRU order or hit/miss
        stats (used by the cluster router's cache-owner check; safe to
        call from another thread — a stale answer only misroutes one
        request, it cannot corrupt the dict under the GIL)."""
        return self.capacity > 0 and key in self._entries

    def peek(self, key: Hashable) -> Optional[Any]:
        """The entry without touching LRU order or hit/miss stats —
        for callers that must inspect an entry before deciding whether
        it counts as a hit (e.g. the engine's service-level check)."""
        if self.capacity > 0:
            return self._entries.get(key)
        return None

    def record_miss(self) -> None:
        """Count a lookup the caller rejected after ``peek`` (absent or
        incompatible entry) without promoting anything."""
        self._misses.inc()

    def touch(self, key: Hashable) -> None:
        """Recency-only promotion for a caller that already ``peek``ed
        and accepted the entry (the slab hit path): refresh LRU order
        without re-counting a hit."""
        if self.capacity > 0 and key in self._entries:
            self._entries.move_to_end(key)

    def add_stats(self, hits: int = 0, misses: int = 0) -> None:
        """Bulk hit/miss accounting for slab probes (one counter lock
        per slab instead of one per request)."""
        if hits:
            self._hits.inc(int(hits))
        if misses:
            self._misses.inc(int(misses))

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity <= 0:
            return
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._evictions.inc()

    def clear(self) -> None:
        """Drop every entry but keep the hit/miss/eviction counters
        (used on policy hot-swaps; telemetry must span versions)."""
        self._entries.clear()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "size": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }
