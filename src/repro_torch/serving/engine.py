"""`ServeEngine`: the online query-serving front door.

Request flow (the reference's docs/serving.md has the full diagram):

    submit → admission → result cache → per-(category, level) shape
           bucket → prepared serve step (per shard, scatter–gather)
           → L1 prune → respond (+ cache fill, telemetry)

The engine wraps an already-trained `RetrievalSystem` (L1 ranker, state
bins) plus per-category `Policy` objects consumed from a versioned
`PolicyStore`.  Passing a plain `{category: Policy}` dict wraps it in a
single-snapshot store; raw Q-table tensors are rejected — wrap them
with `TabularQPolicy`.  A trainer can keep publishing snapshots to the
store while the engine serves: the engine refreshes to the head
snapshot at each drain (flushing the result cache on a version change,
since cached responses embody the old policy) and refuses to serve a
snapshot older than the store's staleness bound.  `serve()` is the
synchronous driver used by benchmarks and the CLI: it submits a stream,
force-flushes the queues, and returns responses in submission order.

The serve step runs on the system's device (CUDA unless the system was
built with ``device="cpu"``); response arrays, the result cache and the
telemetry are host numpy.  A response's ``latency_s`` is host clock
time from admission to response and so includes the device time: the
serve step ends in the device-to-host copy of its outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.policies import Policy, PolicyStore
from repro_torch.serving.array_cache import ArrayResultCache
from repro_torch.serving.batcher import (
    BucketConfig, MicroBatch, PendingRequest, ShapeBucketBatcher,
)
from repro_torch.serving.cache import (LRUResultCache, canonical_query_key,
                                       versioned_key)
from repro_torch.serving.executor import ShardedExecutor
from repro_torch.serving.levels import ServiceLevel
from repro_torch.serving.slab import QueryKeyCache, TicketSlab
from repro_torch.serving.telemetry import Telemetry

__all__ = ["EngineConfig", "ServeResponse", "AdmissionError",
           "CacheOnlyMiss", "ServeEngine", "SLAB_OK",
           "SLAB_ADMISSION_REJECT", "SLAB_CACHED_ONLY_MISS"]

# Per-request statuses returned by ``submit_slab`` (it never raises for
# an individual arrival — a slab is all-or-nothing only for *systemic*
# failures like a stale snapshot, so callers that mapped ids to tickets
# before submitting can always reconcile every lane).
SLAB_OK = 0
SLAB_ADMISSION_REJECT = 1
SLAB_CACHED_ONLY_MISS = 2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    min_bucket: int = 8
    max_bucket: int = 64
    cache_capacity: int = 4096
    n_shards: int = 1
    keep: int = 100                # L1 prune depth (paper's NCG@100 cut)
    admission_limit: int = 4096    # max queued requests before shedding
    max_completed: int = 65536     # unclaimed-response bound (oldest evicted)
    # Scan-backend name of the serve step (core/scan_backends.py);
    # None takes the system's (``SystemConfig.backend``).
    backend: Optional[str] = None
    auto_refresh: bool = True      # pull the head policy snapshot per drain
    cache_impl: str = "array"      # "array" (hot path) | "lru" (dict oracle)


class AdmissionError(RuntimeError):
    """Raised when the pending queue is at admission_limit (load shed)."""


class CacheOnlyMiss(RuntimeError):
    """A CACHED_ONLY submission found no usable cache entry.  The
    cluster normally prevents this (it only prices CACHED_ONLY when the
    owner replica's cache holds the key), so hitting it means an
    eviction raced the routing decision; the caller sheds explicitly."""


@dataclasses.dataclass
class ServeResponse:
    request_id: int
    qid: int
    category: int
    doc_ids: np.ndarray        # (keep,) int32, -1 pad
    scores: np.ndarray         # (keep,) float32
    u: int                     # index blocks accessed (summed over shards)
    cand_cnt: int
    cached: bool
    latency_s: float
    policy_version: int = 0    # snapshot version that produced the result
    index_epoch: int = 0       # index epoch the result was scanned at
                               # (0 = static index, no live tier)
    # The service level that PRODUCED the candidates (result quality):
    # FULL for live-policy rollouts and hits on FULL-filled entries,
    # SHALLOW for fallback-plan rollouts and hits on SHALLOW fills.  A
    # CACHED_ONLY admission therefore reports the level of whatever the
    # cache held; the *admission* decision lives on the cluster ticket.
    level: ServiceLevel = ServiceLevel.FULL


@dataclasses.dataclass
class _CachedResult:
    doc_ids: np.ndarray
    scores: np.ndarray
    u: int
    cand_cnt: int
    level: ServiceLevel = ServiceLevel.FULL


class ServeEngine:
    def __init__(self, system,
                 policies: Union[PolicyStore, Dict[int, Policy]],
                 cfg: EngineConfig = EngineConfig(),
                 tracer: Tracer = NULL_TRACER):
        self.system = system
        self.cfg = cfg
        self.tracer = tracer
        if isinstance(policies, PolicyStore):
            self.store = policies
        elif isinstance(policies, dict):
            # publish() validates entries and rejects raw tensors with
            # a pointer at TabularQPolicy.
            self.store = PolicyStore(staleness_bound=0)
            self.store.publish(policies)
        else:
            raise TypeError(
                "ServeEngine expects a PolicyStore or a {category: Policy} "
                f"dict, got {type(policies).__name__}")
        self._snapshot = self.store.snapshot()
        self.bucket_cfg = BucketConfig(cfg.min_bucket, cfg.max_bucket)
        self.telemetry = Telemetry()
        # Live-index integration: a system with a tiered live index
        # (`repro_torch.index.live.LiveRetrievalSystem`) exposes an
        # IndexEpochStore; static systems expose None
        # and everything below degrades to a constant epoch 0.  The
        # engine pins one epoch like it pins one policy snapshot, and
        # threads it into batch_inputs so a hot swap mid-batch can't
        # mix two indexes.
        self._index_store = getattr(system, "index_epoch_store", None)
        self._index_epoch_snap = (self._index_store.snapshot()
                                  if self._index_store is not None else None)
        self._c_epoch_swaps = self.telemetry.registry.counter(
            "index.epoch_swaps")
        self._g_epoch = self.telemetry.registry.gauge("index.epoch")
        self._g_epoch.set(self.index_epoch)
        self.batcher = ShapeBucketBatcher(self.bucket_cfg)
        # The cache shares the engine's registry so its hit/miss/
        # eviction counters ride the same mergeable snapshot.  "array"
        # is the production hot path (open addressing over preallocated
        # slabs, CLOCK eviction); "lru" keeps the dict/object oracle.
        if cfg.cache_impl == "array":
            self.cache = ArrayResultCache(cfg.cache_capacity, keep=cfg.keep,
                                          registry=self.telemetry.registry)
        elif cfg.cache_impl == "lru":
            self.cache = LRUResultCache(cfg.cache_capacity,
                                        registry=self.telemetry.registry)
        else:
            raise ValueError(f"unknown cache_impl {cfg.cache_impl!r} "
                             "(expected 'array' or 'lru')")
        # qid -> canonical key memo shared by submit and submit_slab
        # (the log is append-only, so memoized keys never go stale).
        self._key_cache = QueryKeyCache(system.log)
        self.executor = ShardedExecutor(system, n_shards=cfg.n_shards,
                                        keep=cfg.keep, backend=cfg.backend)
        self.executor.tracer = tracer
        self._next_id = 0
        # Requests drained from the queue and currently executing; with
        # queue_depth this is the load signal a cross-replica router
        # balances on.
        self._inflight = 0
        # Responses wait here until take_response(); bounded so callers
        # that fire-and-forget don't leak result arrays forever.
        self._completed: Dict[int, ServeResponse] = {}

    def _complete(self, resp: ServeResponse) -> None:
        self._completed[resp.request_id] = resp
        while len(self._completed) > self.cfg.max_completed:
            self._completed.pop(next(iter(self._completed)))

    # ------------------------------------------------------------- gauges
    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet drained into a micro-batch."""
        return self.batcher.pending()

    @property
    def inflight(self) -> int:
        """Real lanes of the micro-batch currently executing (0 idle)."""
        return self._inflight

    # ---------------------------------------------------------- policies
    @property
    def policy_version(self) -> int:
        """Version of the snapshot currently being served."""
        return self._snapshot.version

    def refresh_policies(self) -> bool:
        """Adopt the store's head snapshot.  Returns True on a version
        change; the result cache is flushed then, because cached
        responses were produced by the previous policy."""
        snap = self.store.snapshot()
        if snap.version == self._snapshot.version:
            return False
        self._snapshot = snap
        # Entries filled under the old version are unreachable anyway
        # (the cache key embeds the policy version); clearing is pure
        # memory hygiene so dead entries don't squat LRU capacity.
        self.cache.clear()
        return True

    # -------------------------------------------------------- index epoch
    @property
    def index_epoch(self) -> int:
        """Index epoch currently pinned (0 on a static index)."""
        snap = self._index_epoch_snap
        return snap.version if snap is not None else 0

    def refresh_index(self) -> bool:
        """Adopt the index store's head epoch.  Returns True on a swap.

        Unlike a policy swap, the cache is NOT flushed: the cache key
        embeds the index epoch, so a swap invalidates exactly the
        entries scanned against the old index — fills that raced the
        swap included — while the epoch gauge and swap counter land in
        the metrics plane."""
        if self._index_store is None:
            return False
        head = self._index_store.snapshot()
        snap = self._index_epoch_snap
        if snap is not None and head.version == snap.version:
            return False
        self._index_epoch_snap = head
        self._c_epoch_swaps.inc()
        self._g_epoch.set(head.version)
        return True

    def _versioned_key(self, base_key) -> tuple:
        """The full cache key for a base query key under the currently
        pinned (policy version, index epoch)."""
        return versioned_key(base_key, self._snapshot.version,
                             self.index_epoch)

    def cache_has(self, base_key) -> bool:
        """Does this engine's cache hold a CURRENT entry for the base
        query key — i.e. one filled under the pinned policy version and
        index epoch?  Stats-free and thread-safe like
        ``cache.contains``; the cluster router's owner probe uses this
        so CACHED_ONLY is never priced against an entry a hot swap
        already invalidated."""
        return self.cache.contains(self._versioned_key(base_key))

    def _policy_for(self, category: int,
                    level: ServiceLevel = ServiceLevel.FULL) -> Policy:
        self.store.validate(self._snapshot.version)
        mapping = (self._snapshot.policies if level == ServiceLevel.FULL
                   else self._snapshot.fallbacks)
        try:
            return mapping[category]
        except KeyError:
            role = "policy" if level == ServiceLevel.FULL else "fallback policy"
            raise KeyError(
                f"policy snapshot v{self._snapshot.version} has no {role} "
                f"for category {category}") from None

    # ------------------------------------------------------------ warmup
    def warmup(self) -> int:
        """Prepare every (bucket, policy-structure, level) serve step
        for the current snapshot — fallbacks included, so the first
        degraded micro-batch under pressure never pays a preparation;
        returns the compile count (steps prepared)."""
        self.executor.warmup(self.bucket_cfg.buckets(),
                             self._snapshot.policies.values(),
                             level=int(ServiceLevel.FULL))
        if self._snapshot.fallbacks:
            self.executor.warmup(self.bucket_cfg.buckets(),
                                 self._snapshot.fallbacks.values(),
                                 level=int(ServiceLevel.SHALLOW))
        return self.executor.compile_count

    @property
    def compile_count(self) -> int:
        return self.executor.compile_count

    # ------------------------------------------------------------ submit
    def submit(self, qid: int,
               level: ServiceLevel = ServiceLevel.FULL,
               span=None) -> int:
        """Admit one query-log query at a service level; returns its
        request id.

        Cache hits complete immediately — but only when the cached
        entry's level is at least as good as the request's (a SHALLOW
        fill never silently answers a FULL request; a FULL fill answers
        anyone).  Misses queue for the next micro-batch of their
        (category, level); a CACHED_ONLY miss raises
        :class:`CacheOnlyMiss` instead (it has no u budget to roll out
        with).  Raises AdmissionError when the queue is full.

        ``span`` is the ticket's trace context: the cluster passes the
        root span it opened at admission and keeps ownership (it ends
        the span in its completion callback).  Without one, the engine
        opens — and ends — its own per-ticket root span when tracing
        is enabled.
        """
        level = ServiceLevel(level)
        if level == ServiceLevel.SHED:
            raise ValueError("SHED is not a servable level — the caller "
                             "sheds instead of submitting")
        if self.cfg.auto_refresh:
            # A publish between drains must not leave old-policy cache
            # entries answering new submissions; same for index epochs.
            self.refresh_policies()
            self.refresh_index()
        own_span = span is None
        if own_span:
            span = self.tracer.root_span("ticket", qid=int(qid),
                                         level=int(level))
        t0 = Telemetry.now()
        rid = self._next_id
        self._next_id += 1
        log = self.system.log
        cat = int(log.category[qid])
        key = canonical_query_key(log.terms[qid], cat)
        sub = span.child("submit", category=cat) if span else span
        # Cached responses embody the pinned snapshot's policy AND the
        # pinned index epoch, so both staleness bounds apply to hits
        # exactly as to rollouts.
        self.store.validate(self._snapshot.version)
        if self._index_store is not None:
            self._index_store.validate(self.index_epoch)
        # Peek first: a degraded fill must not answer a better-level
        # request, and a rejected entry must count as a MISS (not a
        # hit) nor be promoted in LRU order — the FULL execution below
        # will overwrite it.  The lookup key embeds (policy version,
        # index epoch): an entry filled at epoch N can never answer a
        # request routed at epoch N+1 (tests/test_live_index.py pins
        # this regression).
        vkey = self._versioned_key(key)
        entry = self.cache.peek(vkey)
        if entry is not None and int(entry.level) <= int(level):
            hit = self.cache.get(vkey)     # counts the hit, refreshes LRU
        else:
            hit = None
            self.cache.record_miss()
        if hit is not None:
            span.instant("cache_hit", level=int(hit.level))
            t1 = Telemetry.now()
            # The key embeds both versions, so a hit always embodies
            # the currently pinned snapshot and epoch.
            self._complete(ServeResponse(
                request_id=rid, qid=int(qid), category=cat,
                doc_ids=hit.doc_ids, scores=hit.scores, u=hit.u,
                cand_cnt=hit.cand_cnt, cached=True, latency_s=t1 - t0,
                policy_version=self._snapshot.version,
                index_epoch=self.index_epoch, level=hit.level))
            self.telemetry.record_request(category=cat, latency_s=t1 - t0,
                                          u=hit.u, cached=True, t_done=t1,
                                          level=int(hit.level))
            sub.end()
            if own_span:
                span.end(cached=True, level=int(hit.level))
            return rid
        span.instant("cache_miss")
        if level == ServiceLevel.CACHED_ONLY:
            sub.end()
            if own_span:
                span.end(error="cache_only_miss")
            raise CacheOnlyMiss(f"qid {qid}: no cache entry for {key}")
        # The queue cap guards the PENDING queue only — a cache hit
        # completes inline without queueing, so it must never be
        # rejected for queue fullness (under saturation, hits are
        # exactly the traffic the CACHED_ONLY rung relies on).
        if self.batcher.pending() >= self.cfg.admission_limit:
            self.telemetry.record_rejection()
            sub.end()
            if own_span:
                span.end(error="admission_limit")
            raise AdmissionError(
                f"pending={self.batcher.pending()} >= {self.cfg.admission_limit}")
        sub.end()
        self.batcher.enqueue(PendingRequest(
            request_id=rid, qid=int(qid), category=cat, cache_key=key,
            t_submit=t0, level=int(level), span=span,
            queue_span=span.child("queue", category=cat,
                                  level=int(level)) if span else span,
            own_span=own_span))
        self.telemetry.observe_gauges(self.queue_depth, self._inflight)
        return rid

    # ----------------------------------------------------- bulk (slabs)
    def submit_slab(self, qids, level: ServiceLevel = ServiceLevel.FULL,
                    levels=None, spans=None):
        """Admit a whole arrival slab; returns ``(rids, statuses)``.

        The batch-granular front door: one refresh + one staleness
        validation per slab, categories gathered in one fancy-index,
        canonical keys through the qid memo, cache hits completed as a
        group (bulk counters, one telemetry slab per (level, category)
        cell), misses enqueued with ``enqueue_many``.  Unlike
        :meth:`submit` it never raises for an *individual* arrival —
        per-request outcomes come back in ``statuses`` (``SLAB_OK`` /
        ``SLAB_ADMISSION_REJECT`` / ``SLAB_CACHED_ONLY_MISS``) so a
        caller that pre-registered tickets can reconcile every lane.
        Systemic failures (stale snapshot/epoch) still raise before any
        request id is assigned.

        ``spans``, when given, carries one trace context per arrival
        (cluster tickets); when absent and tracing is on, the whole
        slab shares ONE "slab" span instead of per-ticket roots — the
        slab-scoped batching that keeps tracing overhead off the
        per-request path.  Bit parity with a loop of :meth:`submit`
        calls on the same starting state is pinned in tier-1 tests
        (the per-ticket path is the B=1 oracle).
        """
        if isinstance(qids, TicketSlab):
            slab = qids
        else:
            slab = TicketSlab.build(self.system.log, qids, level=int(level),
                                    levels=levels)
        n = len(slab)
        lv = slab.levels
        if n and int(lv.max(initial=0)) >= int(ServiceLevel.SHED):
            raise ValueError("SHED is not a servable level — the caller "
                             "sheds instead of submitting")
        if self.cfg.auto_refresh:
            self.refresh_policies()
            self.refresh_index()
        self.store.validate(self._snapshot.version)
        if self._index_store is not None:
            self._index_store.validate(self.index_epoch)
        slab_span = (self.tracer.span("slab", n=n) if spans is None
                     else None)
        t0 = Telemetry.now()
        rid0 = self._next_id
        self._next_id += n
        rids = np.arange(rid0, rid0 + n, dtype=np.int64)
        statuses = np.zeros(n, np.uint8)
        version = self._snapshot.version
        epoch = self.index_epoch
        key_of = self._key_cache.key
        cache = self.cache
        pend0 = self.batcher.pending()
        limit = self.cfg.admission_limit
        cached_only = int(ServiceLevel.CACHED_ONLY)
        hits = []                       # (i, category, entry)
        pending: List[PendingRequest] = []
        queued = 0
        n_rej = 0
        for i in range(n):
            qid = int(slab.qids[i])
            cat = int(slab.categories[i])
            req_level = int(lv[i])
            key = key_of(qid, cat)
            entry = cache.peek((key, version, epoch))
            if entry is not None and int(entry.level) <= req_level:
                cache.touch((key, version, epoch))
                hits.append((i, cat, entry))
                continue
            if req_level == cached_only:
                statuses[i] = SLAB_CACHED_ONLY_MISS
                continue
            if pend0 + queued >= limit:
                statuses[i] = SLAB_ADMISSION_REJECT
                n_rej += 1
                continue
            queued += 1
            span = spans[i] if spans is not None else None
            pending.append(PendingRequest(
                request_id=int(rids[i]), qid=qid, category=cat,
                cache_key=key, t_submit=t0, level=req_level, span=span,
                queue_span=span.child("queue", category=cat,
                                      level=req_level) if span else None,
                own_span=False))
        t1 = Telemetry.now()
        # Hits complete as a group: same responses a scalar loop would
        # produce (identical doc ids / scores / u — latency is the slab
        # probe's), telemetry recorded one (level, category) cell at a
        # time through pre-resolved handles.
        if hits:
            groups: Dict[tuple, list] = {}
            for i, cat, entry in hits:
                self._complete(ServeResponse(
                    request_id=int(rids[i]), qid=int(slab.qids[i]),
                    category=cat, doc_ids=entry.doc_ids,
                    scores=entry.scores, u=entry.u,
                    cand_cnt=entry.cand_cnt, cached=True,
                    latency_s=t1 - t0, policy_version=version,
                    index_epoch=epoch, level=entry.level))
                groups.setdefault((int(entry.level), cat),
                                  []).append(entry.u)
            for (lvl, cat), us in groups.items():
                self.telemetry.record_requests(
                    category=cat, level=lvl,
                    latencies_s=np.full(len(us), t1 - t0), us=us,
                    cached=True, t_done=t1)
        cache.add_stats(hits=len(hits), misses=n - len(hits))
        if n_rej:
            self.telemetry.record_rejection(n_rej)
        if pending:
            self.batcher.enqueue_many(pending)
        self.telemetry.observe_gauges(self.queue_depth, self._inflight)
        if slab_span:
            slab_span.end(hits=len(hits), queued=queued, rejected=n_rej)
        return rids, statuses

    def submit_many(self, qids,
                    level: ServiceLevel = ServiceLevel.FULL,
                    levels=None) -> List[int]:
        """Raising wrapper over :meth:`submit_slab` for callers with
        the per-ticket error contract: any rejected lane raises
        :class:`AdmissionError`, any CACHED_ONLY miss raises
        :class:`CacheOnlyMiss`, otherwise every request id is live."""
        rids, statuses = self.submit_slab(qids, level=level, levels=levels)
        if statuses.any():
            n_rej = int((statuses == SLAB_ADMISSION_REJECT).sum())
            if n_rej:
                raise AdmissionError(
                    f"{n_rej} of {len(rids)} arrivals rejected at "
                    f"admission_limit={self.cfg.admission_limit}")
            raise CacheOnlyMiss(
                f"{int((statuses == SLAB_CACHED_ONLY_MISS).sum())} "
                f"CACHED_ONLY arrivals found no cache entry")
        return [int(r) for r in rids]

    def serve_many(self, qids,
                   level: ServiceLevel = ServiceLevel.FULL
                   ) -> List[ServeResponse]:
        """Synchronous slab driver: bulk-submit, flush, return
        responses in submission order (the batched sibling of
        :meth:`serve`)."""
        rids = self.submit_many(qids, level=level)
        self.flush()
        return [self._completed.pop(r) for r in rids]

    # ------------------------------------------------------------- batch
    def _execute_batch(self, mb: MicroBatch) -> None:
        level = ServiceLevel(mb.level)
        try:
            policy = self._policy_for(mb.category, level)
        except KeyError:
            if level != ServiceLevel.SHALLOW:
                raise
            # A publish cleared the fallbacks while SHALLOW-admitted
            # requests sat in the queue.  Upgrade the batch to FULL
            # (better results, more u) rather than poisoning the
            # FIFO front and shedding the replica's in-flight window.
            level = ServiceLevel.FULL
            policy = self._policy_for(mb.category, level)
            self.tracer.instant("level_upgrade", category=mb.category,
                                n=mb.n_real)
        # Worker-thread view of the batch; each ticket additionally gets
        # batch/execute/respond children on its own track below.
        mb_span = self.tracer.span("microbatch", category=mb.category,
                                   bucket=mb.bucket, n_real=mb.n_real,
                                   level=int(level))
        t0 = Telemetry.now()
        for req in mb.requests:
            if req.queue_span:
                req.queue_span.end(t1=t0)
            self.telemetry.record_queue_wait(category=mb.category,
                                             level=int(level),
                                             wait_s=t0 - req.t_submit)
        self._inflight = mb.n_real
        self.telemetry.observe_gauges(self.queue_depth, self._inflight)
        # Pin the epoch for the whole batch: occupancy, the cache fill
        # key, and the response all report the SAME epoch even if a
        # merge publishes mid-execution (the next drain adopts it).
        epoch_snap = self._index_epoch_snap
        epoch_version = epoch_snap.version if epoch_snap is not None else 0
        if self._index_store is not None:
            self._index_store.validate(epoch_version)
        try:
            qids = mb.padded_qids()
            occ, scores, tp = self.system.batch_inputs(qids,
                                                       epoch=epoch_snap)
            t1 = Telemetry.now()
            ids, sc, u, cnt = self.executor.execute(
                policy, occ, scores, tp, level=int(level))
            t2 = Telemetry.now()
        except Exception as err:
            mb_span.end(error=type(err).__name__)
            raise
        finally:
            self._inflight = 0
            self.telemetry.observe_gauges(self.queue_depth, 0)
        if mb_span:
            mb_span.child_at("batch_inputs", t0, t1)
            mb_span.child_at("execute", t1, t2)
        version = self._snapshot.version
        self.telemetry.record_batch(category=mb.category, bucket=mb.bucket,
                                    n_real=mb.n_real, t_inputs_s=t1 - t0,
                                    t_execute_s=t2 - t1)
        # Padded lanes (>= n_real) are dropped here: never cached, never
        # answered — the bucket-padding invariant the tests pin down.
        for lane, req in enumerate(mb.requests):
            result = _CachedResult(doc_ids=ids[lane], scores=sc[lane],
                                   u=int(u[lane]), cand_cnt=int(cnt[lane]),
                                   level=level)
            # Fill under the versions that PRODUCED the result: the
            # pending request carries the base query key, the versioned
            # key is composed at use time, so a swap between submit and
            # drain can never file a new-epoch result under an old key
            # (or vice versa).
            vkey = versioned_key(req.cache_key, version, epoch_version)
            prior = self.cache.contains(vkey)
            # A SHALLOW fill never downgrades an existing (necessarily
            # >=-quality) entry; FULL fills always win.
            if level == ServiceLevel.FULL or not prior:
                self.cache.put(vkey, result)
            latency = t2 - req.t_submit
            self._complete(ServeResponse(
                request_id=req.request_id, qid=req.qid,
                category=mb.category, doc_ids=result.doc_ids,
                scores=result.scores, u=result.u, cand_cnt=result.cand_cnt,
                cached=False, latency_s=latency, policy_version=version,
                index_epoch=epoch_version, level=level))
            self.telemetry.record_request(category=mb.category,
                                          latency_s=latency, u=result.u,
                                          cached=False, t_done=t2,
                                          level=int(level))
            if req.span:
                # batch covers drain → inputs assembled; execute the
                # rollout; respond the host-side completion.
                req.span.child_at("batch", t0, t1, bucket=mb.bucket)
                req.span.child_at("execute", t1, t2, u=result.u)
                t3 = Telemetry.now()
                req.span.child_at("respond", t2, t3)
                if req.own_span:
                    req.span.end(t1=t3, level=int(level), u=result.u)
        mb_span.end()

    def _drain_queue(self, key: tuple, force: bool) -> int:
        n = 0
        while True:
            mb = self.batcher.drain(key, force=force)
            if mb is None:
                break
            try:
                self._execute_batch(mb)
            except Exception:
                # A failed batch (stale snapshot, missing category,
                # backend error) must not lose admitted requests: put
                # them back at the front of the queue, FIFO preserved,
                # before propagating.
                self.batcher.requeue(mb.requests)
                raise
            n += 1
        return n

    def step(self) -> int:
        """Drain every full bucket; returns micro-batches executed."""
        if self.cfg.auto_refresh:
            self.refresh_policies()
            self.refresh_index()
        return sum(self._drain_queue(key, force=False)
                   for key in self.batcher.queue_keys())

    def flush(self) -> int:
        """Force-drain everything (partial buckets padded up)."""
        n = self.step()
        return n + sum(self._drain_queue(key, force=True)
                       for key in self.batcher.queue_keys())

    # ----------------------------------------------------------- respond
    def take_response(self, request_id: int) -> Optional[ServeResponse]:
        return self._completed.pop(request_id, None)

    def cancel(self, request_ids) -> int:
        """Abandon admitted requests: drop them from the pending queues
        (including requeued failed batches) and discard any unclaimed
        responses.  Returns how many were still queued."""
        request_ids = list(request_ids)
        for rid in request_ids:
            self._completed.pop(rid, None)
        return self.batcher.remove(request_ids)

    def serve(self, qids: Sequence[int],
              level: ServiceLevel = ServiceLevel.FULL) -> List[ServeResponse]:
        """Synchronous driver: submit a stream, flush, return responses
        in submission order."""
        rids = [self.submit(int(q), level) for q in qids]
        self.flush()
        return [self._completed.pop(r) for r in rids]

    def summary(self) -> dict:
        out = self.telemetry.summary(compile_count=self.compile_count)
        out.update({f"cache_{k}": v for k, v in self.cache.stats().items()})
        out["policy_version"] = self.policy_version
        out["index_epoch"] = self.index_epoch
        out["index_epoch_swaps"] = self._c_epoch_swaps.value
        return out
