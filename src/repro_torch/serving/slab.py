"""Ticket slabs: packed struct-of-arrays arrivals for the bulk APIs.

A slab carries a batch of arrivals as parallel NumPy arrays instead of
per-ticket Python objects — the `submit_many` spine (engine, cluster)
moves these around and only materializes per-request objects where a
response must exist.  The slab is deliberately *dumb*: it owns no
behavior beyond construction, so every layer interprets the same five
columns (qid, category, level, epoch, trace root).  The trace roots are
carried as the reference carries them, and read nowhere in either
package: in one process the cluster hands the engine its tickets'
spans (``ServeEngine.submit_slab(spans=)``), and a process worker gets
each ticket's root in its request record (``proc.messages``), where its
spans join the ticket's track by that id.

`QueryKeyCache` memoizes qid → canonical cache key.  The query log is
append-only (a qid's term set never mutates), so memoized keys stay
valid for the log's lifetime; the memo is capacity-bounded with a
wholesale reset because a per-entry LRU would reintroduce exactly the
bookkeeping the slab path removes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.serving.cache import canonical_query_key

__all__ = ["TicketSlab", "QueryKeyCache"]


@dataclasses.dataclass
class TicketSlab:
    """One batch of arrivals, struct-of-arrays."""
    qids: np.ndarray                      # (n,) int64
    categories: np.ndarray                # (n,) int32
    levels: np.ndarray                    # (n,) int8 ServiceLevel values
    epoch: int = 0                        # index epoch at admission
    trace_roots: Optional[np.ndarray] = None   # (n,) uint64; None = off

    def __len__(self) -> int:
        return int(self.qids.size)

    @classmethod
    def build(cls, log, qids, level: int = 0, levels=None,
              epoch: int = 0, trace_roots=None) -> "TicketSlab":
        """Gather categories from the query log in one fancy-index."""
        q = np.asarray(qids, np.int64).ravel()
        cats = np.asarray(log.category)[q].astype(np.int32)
        if levels is None:
            lv = np.full(q.size, int(level), np.int8)
        else:
            lv = np.asarray(levels, np.int8).ravel()
            if lv.size != q.size:
                raise ValueError(f"levels has {lv.size} entries for "
                                 f"{q.size} qids")
        roots = (None if trace_roots is None
                 else np.asarray(trace_roots, np.uint64).ravel())
        return cls(qids=q, categories=cats, levels=lv, epoch=int(epoch),
                   trace_roots=roots)


class QueryKeyCache:
    """qid → canonical (category, sorted term ids) key memo.

    Sound because the query log is append-only; bounded by wholesale
    reset so a long tail of distinct qids cannot grow the memo forever.
    Safe under the GIL without a lock: a racing duplicate computation
    lands the same value.
    """

    def __init__(self, log, capacity: int = 262144):
        self._log = log
        self.capacity = int(capacity)
        self._memo: Dict[int, Tuple[int, Tuple[int, ...]]] = {}

    def __len__(self) -> int:
        return len(self._memo)

    def key(self, qid: int, category: Optional[int] = None):
        qid = int(qid)
        k = self._memo.get(qid)
        if k is None:
            cat = (int(self._log.category[qid]) if category is None
                   else int(category))
            k = canonical_query_key(self._log.terms[qid], cat)
            if len(self._memo) >= self.capacity:
                self._memo.clear()
            self._memo[qid] = k
        return k
