"""Shape-bucketed micro-batching for the serving engine.

A serving loop that forwarded whatever batch composition arrives would
run the serve step at a different batch size almost every batch: the
caching allocator would keep new blocks for each, and each size would
be a new key of the executor's prepared serve steps.  The batcher
quantizes: per-(category, level) FIFO queues are drained into fixed
power-of-two bucket sizes in [min_bucket, max_bucket]; short drains are
padded by replicating a real lane, and the engine drops every lane past
``n_real`` before responding or caching.  In steady state every
micro-batch therefore runs one of a handful of serve steps prepared at
warmup (see executor.py) and the compile count stops growing.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

__all__ = ["BucketConfig", "PendingRequest", "MicroBatch", "ShapeBucketBatcher",
           "bucket_size_for"]


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    min_bucket: int = 8
    max_bucket: int = 64

    def __post_init__(self):
        if self.min_bucket < 1 or self.max_bucket < self.min_bucket:
            raise ValueError(f"bad bucket range [{self.min_bucket}, {self.max_bucket}]")
        for b in (self.min_bucket, self.max_bucket):
            if b & (b - 1):
                raise ValueError(f"bucket bounds must be powers of two, got {b}")

    def buckets(self) -> List[int]:
        """All bucket sizes this config can emit (the compile universe)."""
        out, b = [], self.min_bucket
        while b <= self.max_bucket:
            out.append(b)
            b *= 2
        return out


def bucket_size_for(n: int, cfg: BucketConfig) -> int:
    """Smallest power-of-two bucket ≥ n, clamped to the config range."""
    if n < 1:
        raise ValueError("empty micro-batch")
    b = cfg.min_bucket
    while b < n and b < cfg.max_bucket:
        b *= 2
    return b


@dataclasses.dataclass
class PendingRequest:
    request_id: int
    qid: int               # id into the query log
    category: int
    cache_key: object
    t_submit: float
    level: int = 0         # ServiceLevel value (FULL=0, SHALLOW=1)
    # Ticket-scoped trace context (repro_torch.obs).  ``span`` is the
    # ticket's root span; ``queue_span`` is its open "queue" child,
    # ended when the request drains into a micro-batch.  ``own_span``
    # marks spans the engine created itself (standalone serving) and
    # must therefore end at response time; cluster-provided spans are
    # ended by the cluster's completion callback.
    span: object = None
    queue_span: object = None
    own_span: bool = False


@dataclasses.dataclass
class MicroBatch:
    category: int
    bucket: int
    requests: List[PendingRequest]     # the real lanes, in FIFO order
    level: int = 0         # every lane shares the micro-batch's level

    @property
    def n_real(self) -> int:
        return len(self.requests)

    def padded_qids(self) -> np.ndarray:
        """(bucket,) qids with padded lanes replicating the first real
        lane — its rollout result is discarded, so any valid qid works."""
        qids = np.full(self.bucket, self.requests[0].qid, np.int64)
        qids[: self.n_real] = [r.qid for r in self.requests]
        return qids


class ShapeBucketBatcher:
    """Per-(category, service-level) FIFO queues drained into shape
    buckets.  Levels never mix inside one micro-batch: a SHALLOW lane
    runs the snapshot's fallback policy through a different executable
    than its FULL neighbour, so they batch separately by construction.
    """

    def __init__(self, cfg: BucketConfig = BucketConfig()):
        self.cfg = cfg
        self._queues: Dict[tuple, Deque[PendingRequest]] = {}

    @staticmethod
    def _key(req: PendingRequest) -> tuple:
        return (req.category, int(req.level))

    def enqueue(self, req: PendingRequest) -> None:
        self._queues.setdefault(self._key(req), deque()).append(req)

    def enqueue_many(self, reqs: List[PendingRequest]) -> None:
        """Append a slab of admitted requests in order — same FIFO the
        scalar loop would produce, one queue resolve per run of equal
        (category, level)."""
        queues = self._queues
        last_key, q = None, None
        for req in reqs:
            key = (req.category, int(req.level))
            if key != last_key:
                q = queues.get(key)
                if q is None:
                    q = queues.setdefault(key, deque())
                last_key = key
            q.append(req)

    def requeue(self, reqs: List[PendingRequest]) -> None:
        """Put a drained (but unexecuted) micro-batch back at the FRONT
        of its queues, preserving FIFO order for the retry."""
        for req in reversed(reqs):
            self._queues.setdefault(self._key(req), deque()).appendleft(req)

    def remove(self, request_ids) -> int:
        """Drop queued requests by id (cancellation — e.g. a caller
        giving up on a repeatedly failing batch); returns the count."""
        request_ids = set(request_ids)
        n = 0
        for q in self._queues.values():
            kept = [r for r in q if r.request_id not in request_ids]
            n += len(q) - len(kept)
            q.clear()
            q.extend(kept)
        return n

    def pending(self, key: Optional[tuple] = None) -> int:
        if key is not None:
            return len(self._queues.get(key, ()))
        # list() snapshots the values atomically under the GIL (single
        # C-level call, no bytecode boundary), so this stays safe when
        # a router thread polls while the owning thread enqueues a
        # first-of-its-queue request (which inserts a dict key); a
        # plain generator over .values() can raise "dictionary changed
        # size during iteration" there.
        return sum(len(q) for q in list(self._queues.values()))

    def queue_keys(self) -> List[tuple]:
        """Non-empty (category, level) queues."""
        return [k for k, q in self._queues.items() if q]

    def drain(self, key: tuple, force: bool = False) -> Optional[MicroBatch]:
        """Pop up to max_bucket requests of one (category, level) queue
        into a micro-batch.

        Without ``force``, only a full max_bucket batch is released (the
        throughput-optimal shape); with ``force`` a partial batch drains
        into the smallest fitting bucket — the flush/latency path.
        """
        q = self._queues.get(key)
        if not q:
            return None
        if not force and len(q) < self.cfg.max_bucket:
            return None
        take = min(len(q), self.cfg.max_bucket)
        reqs = [q.popleft() for _ in range(take)]
        category, level = key
        return MicroBatch(category=category,
                          bucket=bucket_size_for(take, self.cfg),
                          requests=reqs, level=level)
