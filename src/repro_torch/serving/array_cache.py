"""Array-backed result cache: the hot-path replacement for the dict LRU.

`LRUResultCache` stores one `_CachedResult` object per entry in an
``OrderedDict`` — every hit allocates nothing but every fill allocates
an object + two array refs, every eviction churns the dict, and the
LRU `move_to_end` rewrites linkage per probe.  At cluster QPS the cache
probe is on the critical path of *every* request, hit or miss, so this
module trades the pointer-chasing structure for preallocated parallel
arrays:

- **Open-addressing index** (linear probing over a power-of-two table,
  tombstones for evictions, stored hashes so most collisions resolve
  without touching the key list).  The table is rebuilt in place when
  tombstones would degrade probe lengths.
- **Value slabs**: doc ids / scores / u / cand_cnt / level live in
  preallocated 2-D arrays indexed by slot — a fill is a row write, not
  an allocation.
- **CLOCK (second-chance) eviction** instead of strict LRU: a hit sets
  a reference bit (one store); eviction sweeps a hand clearing bits
  until it finds an unreferenced victim.  This keeps the *incremental*
  cost of recency maintenance O(1) without `move_to_end`'s dict
  surgery, at the price of approximating LRU — acceptable because the
  cache key already embeds (policy version, index epoch), so
  correctness never depends on eviction order, only hit rate does.

The class is protocol-compatible with `LRUResultCache` (get / peek /
contains / touch / record_miss / add_stats / put / clear / stats /
hits / misses / evictions / hit_rate / ``capacity <= 0`` disables), so
`EngineConfig.cache_impl` can flip between the two and the per-ticket
path stays available as the parity oracle.  ``get``/``peek`` return a
:class:`CacheEntry` whose arrays are *copies* — a caller must never
alias a slot row that a later fill may overwrite.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable, List, Optional

import numpy as np

from repro_torch.obs import Counter, MetricsRegistry
from repro_torch.serving.levels import ServiceLevel

__all__ = ["ArrayResultCache", "CacheEntry"]

_EMPTY = -1       # open-addressing cell states
_TOMB = -2

#: int -> ServiceLevel member; the enum ctor is ~0.5us per call, a
#: dict hit is ~50ns, and _entry runs once per cache hit.
_LEVEL_OF = {int(l): l for l in ServiceLevel}


@dataclasses.dataclass
class CacheEntry:
    """Materialized view of one cached result (field-compatible with
    the engine's `_CachedResult`); arrays are owned copies."""
    doc_ids: np.ndarray
    scores: np.ndarray
    u: int
    cand_cnt: int
    level: ServiceLevel = ServiceLevel.FULL


class ArrayResultCache:
    """Open-addressing + CLOCK result cache over preallocated arrays.

    ``keep`` (the per-entry doc count) may be given up front or learned
    from the first ``put`` — the serving engine always fills rows of
    its configured L1 prune depth, so the slabs never reallocate after
    warmup.
    """

    def __init__(self, capacity: int = 4096, keep: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        self.capacity = int(capacity)
        reg = registry.counter if registry is not None else (
            lambda name: Counter())
        self._hits = reg("cache.hits")
        self._misses = reg("cache.misses")
        self._evictions = reg("cache.evictions")
        self._size = 0
        self._hand = 0
        self._keep = int(keep)
        if self.capacity > 0:
            self._alloc_table()
            if self._keep > 0:
                self._alloc_values()

    # ------------------------------------------------------------- layout
    def _alloc_table(self) -> None:
        # Plain Python lists, not numpy: the index is touched one cell
        # at a time on every probe, and list indexing is ~10x cheaper
        # than numpy scalar indexing.  Only the value slabs (row reads/
        # writes) benefit from being arrays.
        t = 4
        while t < 2 * self.capacity:
            t <<= 1
        self._tmask = t - 1
        self._table = [_EMPTY] * t                   # cell -> slot | state
        self._thash = [0] * t                        # stored key hashes
        self._tombs = 0

    def _alloc_values(self) -> None:
        cap, keep = self.capacity, self._keep
        self._ids = np.full((cap, keep), -1, np.int32)
        self._scores = np.zeros((cap, keep), np.float32)
        self._u = [0] * cap
        self._cand = [0] * cap
        self._level = [0] * cap
        self._ndocs = [0] * cap
        self._ref = [0] * cap                        # CLOCK reference bits
        self._tpos = [-1] * cap                      # slot -> table cell
        self._keys: List[Any] = [None] * cap

    def _grow_keep(self, keep: int) -> None:
        ids = np.full((self.capacity, keep), -1, np.int32)
        sc = np.zeros((self.capacity, keep), np.float32)
        ids[:, :self._keep] = self._ids
        sc[:, :self._keep] = self._scores
        self._ids, self._scores, self._keep = ids, sc, keep

    # -------------------------------------------------------------- index
    def _find(self, key: Hashable):
        """-> (slot | -1, insertion cell, hash).  The insertion cell is
        the first tombstone on the probe path (reuse) or the empty cell
        that terminated it."""
        h = hash(key) & 0x7FFFFFFFFFFFFFFF
        i = h & self._tmask
        table, thash, keys = self._table, self._thash, self._keys
        ins = -1
        while True:
            s = table[i]
            if s == _EMPTY:
                return -1, (i if ins < 0 else ins), h
            if s == _TOMB:
                if ins < 0:
                    ins = i
            elif thash[i] == h and keys[s] == key:
                return s, i, h
            i = (i + 1) & self._tmask

    def _rebuild(self) -> None:
        """Reinsert live slots into a clean table (drops tombstones)."""
        table = self._table = [_EMPTY] * (self._tmask + 1)
        self._tombs = 0
        for s in range(self._size):
            key = self._keys[s]
            if key is None:
                continue
            h = hash(key) & 0x7FFFFFFFFFFFFFFF
            i = h & self._tmask
            while table[i] != _EMPTY:
                i = (i + 1) & self._tmask
            table[i] = s
            self._thash[i] = h
            self._tpos[s] = i

    def _evict(self) -> int:
        """CLOCK sweep: clear reference bits until an unreferenced slot
        turns up; detach it from the index and hand it to the caller."""
        ref = self._ref
        while True:
            s = self._hand
            self._hand = (self._hand + 1) % self.capacity
            if ref[s]:
                ref[s] = 0
                continue
            cell = self._tpos[s]
            self._table[cell] = _TOMB
            self._tombs += 1
            self._keys[s] = None
            self._evictions.inc()
            return s

    def _entry(self, s: int) -> CacheEntry:
        # Bypasses the dataclass __init__ (signature binding alone is
        # most of a microsecond); the row copies are the contract — a
        # caller must never alias a slot a later fill may overwrite.
        n = self._ndocs[s]
        e = CacheEntry.__new__(CacheEntry)
        e.doc_ids = self._ids[s, :n].copy()
        e.scores = self._scores[s, :n].copy()
        e.u = self._u[s]
        e.cand_cnt = self._cand[s]
        e.level = _LEVEL_OF[self._level[s]]
        return e

    # ----------------------------------------------------------- protocol
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
        return self._size if self.capacity > 0 else 0

    def get(self, key: Hashable) -> Optional[CacheEntry]:
        if self.capacity > 0 and self._size:
            s, _, _ = self._find(key)
            if s >= 0:
                self._ref[s] = 1
                self._hits.inc()
                return self._entry(s)
        self._misses.inc()
        return None

    def peek(self, key: Hashable) -> Optional[CacheEntry]:
        """Entry without recency or hit/miss side effects."""
        if self.capacity > 0 and self._size:
            s, _, _ = self._find(key)
            if s >= 0:
                return self._entry(s)
        return None

    def contains(self, key: Hashable) -> bool:
        return (self.capacity > 0 and self._size > 0
                and self._find(key)[0] >= 0)

    def touch(self, key: Hashable) -> None:
        """Recency-only promotion for a caller that already ``peek``ed
        and accepted the entry (the slab hit path): sets the CLOCK bit
        without re-probing stats."""
        if self.capacity > 0 and self._size:
            s, _, _ = self._find(key)
            if s >= 0:
                self._ref[s] = 1

    def record_miss(self) -> None:
        self._misses.inc()

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
        ids = np.asarray(value.doc_ids, np.int32).ravel()
        scores = np.asarray(value.scores, np.float32).ravel()
        n = int(ids.size)
        if self._keep == 0:
            self._keep = max(n, 1)
            self._alloc_values()
        elif n > self._keep:
            self._grow_keep(n)
        s, cell, h = self._find(key)
        if s < 0:
            # Amortized hygiene: rebuild before tombstones stretch probe
            # chains (live + tombs capped at ~70% of the table).
            if (self._size + self._tombs) * 10 >= (self._tmask + 1) * 7:
                self._rebuild()
                _, cell, h = self._find(key)
            if self._size < self.capacity:
                s = self._size
                self._size += 1
            else:
                # Eviction turns the victim's cell into a tombstone; the
                # insertion cell found above stays valid (it was empty
                # or already a tombstone on this key's probe path).
                s = self._evict()
            if self._table[cell] == _TOMB:
                self._tombs -= 1
            self._table[cell] = s
            self._thash[cell] = h
            self._tpos[s] = cell
            self._keys[s] = key
        self._ids[s, :n] = ids
        self._scores[s, :n] = scores
        if n < self._keep:                # pad only when the row is short
            self._ids[s, n:] = -1
            self._scores[s, n:] = 0.0
        self._u[s] = int(value.u)
        self._cand[s] = int(value.cand_cnt)
        self._level[s] = int(value.level)
        self._ndocs[s] = n
        self._ref[s] = 1

    def clear(self) -> None:
        """Drop every entry, keep counters (policy hot-swap hygiene)."""
        if self.capacity <= 0:
            return
        self._table = [_EMPTY] * (self._tmask + 1)
        self._tombs = 0
        self._size = 0
        self._hand = 0
        if self._keep > 0:
            self._keys = [None] * self.capacity
            self._ref = [0] * self.capacity

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "size": len(self),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }
