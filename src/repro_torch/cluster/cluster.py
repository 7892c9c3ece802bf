"""`ReplicaSet`: the online-learning cluster front door (the port's copy
of the reference's ``cluster/cluster.py``, thread backend only).

Topology (the reference's docs/cluster.md has the full diagram):

    TrainerLoop ◄──sample── ServedTrafficTap ◄──record── completions
        │ publish (policies + fallbacks)
        ▼
    PolicyStore ◄──snapshot── Replica 0..N-1
                                  ▲
    submit ─► AdmissionController ─► Router ─► inbox
              (service ladder:       (affinity + depth spill
               FULL/SHALLOW/          + owner-saturation spill)
               CACHED_ONLY/SHED)

One `RetrievalSystem` (the index is process-shared and read-only) backs
N `ServeEngine` replicas, each with its own worker thread, micro-batch
queues, and result cache.  `submit` estimates the query's u-cost from
its category/df features and walks the admission ladder against the
fleet ledger's headroom: FULL while reservations are comfortable,
SHALLOW (the snapshot's bounded-u fallback plan) under pressure,
CACHED_ONLY when not even that fits but a replica's cache holds the
key, and an explicit `Shed` only as the last rung.  Completions
release the u reservation, feed the realized u back into the
(per-level, per-snapshot-version) estimator, record the response's
policy version lag (bounded by the store's staleness check, surfaced
in `stats()`), and land in the `ServedTrafficTap` the trainer samples.

The reference's second backend, worker processes over shared-memory
rings and one mmapped index (``backend="process"``), is the process
cell; it is not ported yet and raises ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict, deque
from typing import Deque, List, Optional, Sequence, Union

import numpy as np

from repro_torch.obs import (NULL_TRACER, EventLog, FlightRecorder,
                             HeartbeatWatchdog, MetricsRegistry, Tracer,
                             merge_snapshots, write_chrome_entries)
from repro_torch.obs import health as _health
from repro_torch.policies import PolicyStore
from repro_torch.serving import EngineConfig, ServiceLevel
from repro_torch.serving.cache import canonical_query_key
from repro_torch.serving.engine import ServeResponse
from repro_torch.serving.slab import QueryKeyCache
from repro_torch.serving.telemetry import pct as _pct

from .admission import AdmissionController, Shed, UCostEstimator
from .replica import ClusterTicket, Replica
from .router import make_router, stable_query_hash
from .tap import ServedTrafficTap

__all__ = ["ClusterConfig", "ReplicaSet"]

Result = Union[ServeResponse, Shed]


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    n_replicas: int = 2
    # "thread": N ServeEngines on worker threads in this process.
    # "process" (the reference's worker processes) is not ported yet.
    backend: str = "thread"
    routing: str = "queue_aware"          # or "round_robin"
    spill_margin: int = 4                 # depth gap before spilling
    owner_spill_depth: Optional[int] = 32  # sticky-owner saturation gauge
    u_inflight_budget: float = float("inf")   # fleet u budget (inf = no shed)
    ladder: bool = True                   # graceful degradation (False = binary)
    full_watermark: float = 0.5           # budget fraction FULL may reserve
    prior_u: Optional[float] = None       # cold-bucket u estimate (FULL)
    prior_shallow_u: Optional[float] = None   # cold-bucket estimate (SHALLOW)
    n_df_bins: int = 8
    window: int = 65536                   # lag/latency sample window
    affinity_table: int = 65536           # key -> cache-owner LRU entries
    tap_capacity: int = 8192              # served-traffic window per category
    tap_degraded_boost: float = 2.0       # tap weight for non-FULL tickets
    tap_holdout_every: int = 0            # divert every Nth record to the
                                          # eval holdout (0 = off)
    tap_holdout_capacity: int = 1024      # held-out window per category


class ReplicaSet:
    """N replicas + router + admission over one system and store."""

    def __init__(self, system, store: PolicyStore,
                 cfg: ClusterConfig = ClusterConfig(),
                 engine_cfg: EngineConfig = EngineConfig(),
                 tracer: Tracer = NULL_TRACER):
        if cfg.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if cfg.backend == "process":
            raise NotImplementedError(
                "replica backend 'process' is not ported yet: the process "
                "cell (worker processes over shared-memory rings) is the "
                "next slice; use backend='thread'")
        if cfg.backend != "thread":
            raise ValueError(f"unknown replica backend {cfg.backend!r} "
                             "(expected 'thread')")
        self.system = system
        self.store = store
        self.cfg = cfg
        self.tracer = tracer
        # Cluster-plane instruments (admission/routing); replica-plane
        # metrics live in each engine's registry and fold together in
        # metrics_snapshot().
        self.registry = MetricsRegistry()
        self._c_submitted = self.registry.counter("cluster.submitted")
        self._c_shed = self.registry.counter("cluster.shed",
                                             where="admission")
        self._c_shed_replica = self.registry.counter("cluster.shed",
                                                     where="replica")
        # Flight recorder: bounded structured event ring (publishes,
        # epoch swaps, level transitions, sheds); the thread backend
        # records events and writes no bundle.
        self.events = EventLog(registry=self.registry)
        self.recorder = FlightRecorder(
            self.events,
            config={"backend": cfg.backend, "n_replicas": cfg.n_replicas,
                    "routing": cfg.routing, "ladder": cfg.ladder,
                    "u_inflight_budget": cfg.u_inflight_budget})
        self._last_level: Optional[int] = None
        self._last_generation: Optional[int] = None
        self.router = make_router(cfg.routing, spill_margin=cfg.spill_margin,
                                  owner_spill_depth=cfg.owner_spill_depth,
                                  registry=self.registry)
        self.admission = AdmissionController(
            UCostEstimator(system, n_df_bins=cfg.n_df_bins,
                           prior_u=cfg.prior_u,
                           prior_shallow_u=cfg.prior_shallow_u),
            u_inflight_budget=cfg.u_inflight_budget,
            ladder=cfg.ladder, full_watermark=cfg.full_watermark,
            registry=self.registry)
        # Every completion (responses AND sheds) is recorded here; a
        # TrainerLoop pointed at it learns from served traffic instead
        # of the query log (docs/cluster.md, "trainer tap").
        self.tap = ServedTrafficTap(capacity=cfg.tap_capacity,
                                    degraded_boost=cfg.tap_degraded_boost,
                                    holdout_every=cfg.tap_holdout_every,
                                    holdout_capacity=cfg.tap_holdout_capacity)
        self._unsubscribes: List = []
        self.replicas: List[Replica] = [
            Replica(i, system, store, engine_cfg,
                    on_complete=self._on_complete, tracer=tracer)
            for i in range(cfg.n_replicas)
        ]
        self._lock = threading.Lock()
        # (key, policy_version, index_epoch) -> replica whose result
        # cache owns it (LRU-bounded); repeats route back there
        # regardless of depth — a hit is nearly free, a balanced miss
        # elsewhere costs a rollout.  Versioned like the cache keys
        # themselves: a policy publish or index epoch swap retires the
        # old entries by never looking them up again (LRU reclaims
        # them), so stale affinity can't pin post-swap traffic to a
        # replica whose entry is already invalid.
        self._key_owner: "OrderedDict" = OrderedDict()
        # qid -> canonical key memo for the slab front door (append-only
        # log keeps it sound; bounded inside).
        self._qkey_cache = QueryKeyCache(system.log)
        self._lags: Deque[int] = deque(maxlen=cfg.window)
        self._epoch_lags: Deque[int] = deque(maxlen=cfg.window)
        self._g_epoch_lag = self.registry.gauge("index.epoch_lag")
        self._latencies: Deque[float] = deque(maxlen=cfg.window)
        self.n_submitted = 0
        self.n_responses = 0
        self.n_shed = 0
        self._started = False

    def _subscribe_events(self) -> None:
        """Record every publish into the flight recorder: policy
        publishes, and index epoch swaps split into plain swaps vs
        merges (a merge publishes a NEW base generation — the
        generation bump is the tell; a static system has no epoch
        store, so only policy publishes land)."""
        def on_policy(snap) -> None:
            self.events.record("policy_publish", version=snap.version,
                               n_policies=len(snap.policies),
                               n_fallbacks=len(snap.fallbacks))

        self._unsubscribes.append(self.store.subscribe(on_policy))
        index_store = getattr(self.system, "index_epoch_store", None)
        if index_store is not None:
            with self._lock:
                if self._last_generation is None:
                    self._last_generation = index_store.snapshot().generation

            def on_epoch(epoch) -> None:
                gen = epoch.generation
                with self._lock:
                    merged = (self._last_generation is not None
                              and gen > self._last_generation)
                    self._last_generation = gen
                self.events.record(
                    "index_merge" if merged else "epoch_swap",
                    version=epoch.version, generation=gen,
                    n_ops=len(epoch.ops))

            self._unsubscribes.append(index_store.subscribe(on_epoch))

    # ------------------------------------------------------------ control
    def start(self) -> "ReplicaSet":
        for r in self.replicas:
            r.start()
        self._subscribe_events()
        self._started = True
        return self

    def stop(self, drain: bool = True) -> None:
        for unsub in self._unsubscribes:
            unsub()
        self._unsubscribes = []
        for r in self.replicas:
            r.stop(drain=drain)
        self._started = False

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    def warmup(self) -> int:
        """Prepare every replica's serve steps (serially, before the
        worker threads start: the first launch of a kernel builds and
        loads it); returns the steps prepared."""
        return sum(r.warmup() for r in self.replicas)

    # ------------------------------------------------------------- submit
    def submit(self, qid: int) -> ClusterTicket:
        """Admit one query down the service ladder and route it; always
        returns a ticket that completes with either a ServeResponse or
        an explicit Shed — never drops."""
        qid = int(qid)
        cat = int(self.system.log.category[qid])
        key = canonical_query_key(self.system.log.terms[qid], cat)
        ticket = ClusterTicket(qid, cat, cache_key=key)
        # Affinity is versioned alongside the cache entries it points
        # at: after a policy publish or an index epoch swap, the old
        # (key, version, epoch) rows simply stop matching.
        okey = (key, self.store.version,
                getattr(self.system, "index_epoch", 0))
        # One trace track per ticket: the admit → queue → batch →
        # execute → respond chain lives on it, ended at completion.
        ticket.span = self.tracer.root_span("ticket", qid=qid, category=cat)
        self._c_submitted.inc()
        with self._lock:
            self.n_submitted += 1
            owner = self._key_owner.get(okey)
        # Sticky routing (and the CACHED_ONLY rung) only pay while the
        # owner's result cache still holds a CURRENT entry for the key
        # — cache_has folds in the replica's pinned policy version and
        # index epoch (the repeat is ~free there); once evicted or
        # invalidated by a swap, the request must load-balance like any
        # other miss — pinning dead keys to a busy owner is exactly
        # how tails grow.
        if owner is not None and not self.replicas[owner].cache_has(key):
            owner = None
        # The SHALLOW rung is only real if the head snapshot ships a
        # fallback policy for this category (they travel together).
        adm_span = ticket.span.child("admit")
        adm = self.admission.decide(
            qid, cache_available=owner is not None,
            shallow_available=cat in self.store.snapshot().fallbacks)
        adm_span.end(level=ServiceLevel(adm.level).name, est_u=adm.est_u)
        ticket.est_u = adm.est_u
        ticket.reserved_u = adm.reserved_u
        ticket.level = adm.level
        # Service-level transitions are fleet state changes worth a
        # flight-recorder entry: record when the admitted level CHANGES
        # (FULL→SHALLOW means pressure arrived; back again means it
        # passed), not per ticket — the ring must hold history, not QPS.
        with self._lock:
            level_changed = self._last_level != int(adm.level)
            prev_level = self._last_level
            self._last_level = int(adm.level)
        if level_changed:
            self.events.record(
                "level_transition",
                level=ServiceLevel(adm.level).name,
                prev=(ServiceLevel(prev_level).name
                      if prev_level is not None else None),
                qid=qid)
        if adm.level == ServiceLevel.SHED:
            self._c_shed.inc()
            self.events.record("shed", where="admission",
                               reason="u_budget_hot", qid=qid)
            with self._lock:
                self.n_shed += 1
            self.tap.record(qid, cat, ServiceLevel.SHED,
                            index_epoch=getattr(self.system,
                                                "index_epoch", 0))
            ticket.complete(Shed(qid, cat, adm.est_u, "u_budget_hot"))
            if ticket.span:
                ticket.span.end(level="SHED", reason="u_budget_hot")
            return ticket
        if adm.level == ServiceLevel.CACHED_ONLY:
            # only priced when the owner's cache holds the key; route
            # straight there — no other replica can serve it for ~0 u
            idx = owner
        else:
            # The sticky path (the common case under a hot head) needs
            # only the owner's gauge, so skip the per-replica sweep
            # unless the router itself says it will need real depths
            # (owner absent, or saturated past its spill threshold).
            if (owner is not None
                    and not self.router.wants_full_depths(
                        d_owner := self.replicas[owner].depth())):
                depths = [0] * len(self.replicas)
                depths[owner] = d_owner
            else:
                depths = [r.depth() for r in self.replicas]
                if owner is not None:
                    # keep the router's decision consistent with the
                    # gauge that just crossed the threshold
                    depths[owner] = d_owner
            idx = self.router.pick(stable_query_hash(key), depths, owner)
        if ticket.span:
            ticket.span.instant("route", replica=idx,
                                sticky=owner is not None and idx == owner)
            # Covers route → replica-thread pickup; the replica ends it.
            ticket.inbox_span = ticket.span.child("inbox", replica=idx)
        with self._lock:
            self._key_owner[okey] = idx
            self._key_owner.move_to_end(okey)
            while len(self._key_owner) > self.cfg.affinity_table:
                self._key_owner.popitem(last=False)
        self.replicas[idx].enqueue(ticket)
        return ticket

    def serve(self, qids: Sequence[int],
              timeout_s: float = 120.0) -> List[Result]:
        """Synchronous driver: submit a stream, wait for every ticket,
        return results (ServeResponse | Shed) in submission order."""
        if not self._started:
            raise RuntimeError("ReplicaSet not started (use start() or `with`)")
        tickets = [self.submit(q) for q in qids]
        out = []
        for t in tickets:
            res = t.result(timeout=timeout_s)
            if res is None:
                raise TimeoutError(
                    f"qid {t.qid} not served within {timeout_s}s "
                    f"(replica {t.replica})")
            out.append(res)
        return out

    # ------------------------------------------------------- bulk (slabs)
    def submit_many(self, qids) -> List[ClusterTicket]:
        """Admit a whole arrival slab; returns one ticket per query.

        The batched front door: canonical keys come from the qid memo,
        owner lookups take ONE affinity-table lock, the whole slab is
        priced by :meth:`AdmissionController.decide_many` (one ledger
        lock, vectorized estimation), replica depths are snapshotted
        once and updated locally as the slab routes, and each replica
        receives its share through ``enqueue_many`` (one condition
        acquisition + one wake per replica instead of per ticket).

        Semantics match a loop of :meth:`submit` calls: every ticket
        completes with a ServeResponse or an explicit Shed, admission
        levels are identical to the sequential walk (decide_many is
        bit-parity pinned), and level-transition / shed events land in
        the flight recorder the same way.  Routing may differ from the
        sequential interleaving only through the depth snapshot (one
        sweep per slab, locally incremented, instead of re-reading
        depths between arrivals) — response content is
        replica-independent, so parity tests pin doc ids / scores / u,
        not placement.
        """
        qids = [int(q) for q in qids]
        n = len(qids)
        if n == 0:
            return []
        log = self.system.log
        cats = np.asarray(log.category)[np.asarray(qids, np.int64)]
        key_of = self._qkey_cache.key
        keys = [key_of(q, int(c)) for q, c in zip(qids, cats)]
        version = self.store.version
        epoch = getattr(self.system, "index_epoch", 0)
        tracing = self.tracer.enabled
        slab_span = (self.tracer.span("slab_admit", n=n) if tracing
                     else None)
        tickets = []
        for q, c, k in zip(qids, cats, keys):
            t = ClusterTicket(q, int(c), cache_key=k)
            if tracing:
                t.span = self.tracer.root_span("ticket", qid=q,
                                               category=int(c))
            tickets.append(t)
        self._c_submitted.inc(n)
        with self._lock:
            self.n_submitted += n
            owners = [self._key_owner.get((k, version, epoch))
                      for k in keys]
        replicas = self.replicas
        owners = [o if (o is not None and replicas[o].cache_has(k))
                  else None
                  for o, k in zip(owners, keys)]
        fallbacks = self.store.snapshot().fallbacks
        levels, reserves, est_full = self.admission.decide_many(
            qids,
            cache_available=[o is not None for o in owners],
            shallow_available=[int(c) in fallbacks for c in cats])
        # Flight-recorder bookkeeping: transitions on CHANGE only, same
        # contract as the sequential path.
        transitions = []
        with self._lock:
            for i in range(n):
                lvl = int(levels[i])
                if self._last_level != lvl:
                    transitions.append((lvl, self._last_level, qids[i]))
                    self._last_level = lvl
        for lvl, prev, qid in transitions:
            self.events.record(
                "level_transition", level=ServiceLevel(lvl).name,
                prev=(ServiceLevel(prev).name if prev is not None
                      else None), qid=qid)
        depths = None
        shed_level = int(ServiceLevel.SHED)
        cached_only = int(ServiceLevel.CACHED_ONLY)
        level_of = {int(l): l for l in ServiceLevel}   # skip the enum ctor
        n_shed = 0
        assigned = []                       # (okey, idx) owner updates
        groups: "OrderedDict[int, list]" = OrderedDict()
        for i, ticket in enumerate(tickets):
            lvl = int(levels[i])
            ticket.est_u = float(est_full[i])
            ticket.reserved_u = float(reserves[i])
            ticket.level = level_of[lvl]
            if lvl == shed_level:
                n_shed += 1
                self.events.record("shed", where="admission",
                                   reason="u_budget_hot", qid=ticket.qid)
                self.tap.record(ticket.qid, ticket.category,
                                ServiceLevel.SHED, index_epoch=epoch)
                ticket.complete(Shed(ticket.qid, ticket.category,
                                     ticket.est_u, "u_budget_hot"))
                if ticket.span:
                    ticket.span.end(level="SHED", reason="u_budget_hot")
                continue
            owner = owners[i]
            if lvl == cached_only:
                idx = owner
            else:
                if depths is None:
                    depths = [r.depth() for r in replicas]
                idx = self.router.pick(stable_query_hash(keys[i]),
                                       depths, owner)
                # Local view of the work this slab already placed: the
                # sequential path re-reads depths per arrival and sees
                # its own earlier enqueues the same way.
                depths[idx] += 1
            if ticket.span:
                ticket.span.instant("route", replica=idx,
                                    sticky=owner is not None
                                    and idx == owner)
                ticket.inbox_span = ticket.span.child("inbox", replica=idx)
            assigned.append(((keys[i], version, epoch), idx))
            groups.setdefault(idx, []).append(ticket)
        if n_shed:
            self._c_shed.inc(n_shed)
            with self._lock:
                self.n_shed += n_shed
        if assigned:
            with self._lock:
                for okey, idx in assigned:
                    self._key_owner[okey] = idx
                    self._key_owner.move_to_end(okey)
                while len(self._key_owner) > self.cfg.affinity_table:
                    self._key_owner.popitem(last=False)
        for idx, group in groups.items():
            replicas[idx].enqueue_many(group)
        if slab_span:
            slab_span.end(shed=n_shed, routed=len(assigned))
        return tickets

    def serve_many(self, qids, timeout_s: float = 120.0) -> List[Result]:
        """Synchronous slab driver: bulk-submit, wait for every ticket,
        return results in submission order (the batched sibling of
        :meth:`serve`)."""
        if not self._started:
            raise RuntimeError("ReplicaSet not started (use start() or `with`)")
        tickets = self.submit_many(qids)
        out = []
        for t in tickets:
            res = t.result(timeout=timeout_s)
            if res is None:
                raise TimeoutError(
                    f"qid {t.qid} not served within {timeout_s}s "
                    f"(replica {t.replica})")
            out.append(res)
        return out

    # --------------------------------------------------------- completion
    def _on_complete(self, ticket: ClusterTicket, result: Result) -> None:
        if isinstance(result, ServeResponse):
            # Cached responses replay a previous rollout's u — only a
            # fresh execution is a realized observation the estimator
            # should learn from (at the level+version that produced it).
            self.admission.release(
                ticket.reserved_u,
                actual_u=None if result.cached else result.u,
                qid=ticket.qid, level=result.level,
                version=result.policy_version,
                index_epoch=result.index_epoch)
            lag = max(0, self.store.version - result.policy_version)
            # Freshness lag: epochs between the index that produced the
            # response and the head — how stale the answer's view of
            # the corpus was, the live-index analogue of policy lag.
            head_epoch = getattr(self.system, "index_epoch", 0)
            epoch_lag = max(0, head_epoch - result.index_epoch)
            with self._lock:
                self.n_responses += 1
                self._lags.append(lag)
                self._epoch_lags.append(epoch_lag)
                self._latencies.append(ticket.latency_s)
            self._g_epoch_lag.set(epoch_lag)
            self.tap.record(ticket.qid, ticket.category, ticket.level,
                            index_epoch=result.index_epoch)
            if ticket.span:
                ticket.span.end(level=ServiceLevel(result.level).name,
                                u=result.u, cached=result.cached,
                                version=result.policy_version,
                                index_epoch=result.index_epoch)
        else:  # shed inside the replica (queue full / shutdown / error)
            self.admission.release(ticket.reserved_u)
            self._c_shed_replica.inc()
            self.events.record("shed", where="replica",
                               reason=getattr(result, "reason", None),
                               qid=ticket.qid, replica=ticket.replica)
            with self._lock:
                self.n_shed += 1
            self.tap.record(ticket.qid, ticket.category, ServiceLevel.SHED,
                            index_epoch=getattr(self.system,
                                                "index_epoch", 0))
            if ticket.span:
                ticket.span.end(level="SHED",
                                reason=getattr(result, "reason", None))

    # -------------------------------------------------------------- stats
    def metrics_snapshot(self) -> dict:
        """The fleet metrics view: every replica registry (request/
        latency/u/queue-wait instruments, cache counters) folded into
        one snapshot with the cluster-plane instruments — counters and
        histograms add, gauges take their declared aggregation (max by
        default, sum for depth-style gauges).  JSON-serializable; this
        is what ``--metrics-json`` writes."""
        return merge_snapshots(
            [r.metrics_snapshot() for r in self.replicas]
            + [self.registry.snapshot()])

    def statusz(self, watchdog: Optional[HeartbeatWatchdog] = None) -> dict:
        """One-page cell introspection JSON (repro.obs.health)."""
        return _health.statusz(self, watchdog)

    def trace_entries(self) -> list:
        """The fleet's span entries: the shared tracer's log (admit and
        route on the submit thread, engine spans on the replica
        threads) — one timeline on one clock."""
        return self.tracer.log.snapshot() if self.tracer.enabled else []

    def write_trace(self, path, process_name: str = "repro-cluster") -> int:
        """Export the fleet timeline as one Chrome/Perfetto
        trace; returns the number of span entries written."""
        entries = self.trace_entries()
        write_chrome_entries(path, entries, process_name=process_name)
        return len(entries)

    def version_lag(self) -> dict:
        """Current per-replica lag vs the store head, plus the response
        window's observed lag distribution."""
        head = self.store.version
        current = [max(0, head - r.policy_version) for r in self.replicas]
        with self._lock:
            lags = list(self._lags)
        return {
            "head_version": head,
            "replica_versions": [r.policy_version for r in self.replicas],
            "current_max": max(current) if current else 0,
            "observed_max": max(lags) if lags else 0,
            "observed_mean": float(np.mean(lags)) if lags else 0.0,
        }

    def stats(self) -> dict:
        with self._lock:
            lat = list(self._latencies)
            n_sub, n_resp, n_shed = (self.n_submitted, self.n_responses,
                                     self.n_shed)
        lag = self.version_lag()
        with self._lock:
            epoch_lags = list(self._epoch_lags)
        return {
            "n_replicas": len(self.replicas),
            "index_epoch_head": getattr(self.system, "index_epoch", 0),
            "replica_index_epochs": [r.index_epoch for r in self.replicas],
            "epoch_lag_observed_max": max(epoch_lags) if epoch_lags else 0,
            "epoch_lag_observed_mean": (float(np.mean(epoch_lags))
                                        if epoch_lags else 0.0),
            "n_submitted": n_sub,
            "n_responses": n_resp,
            "n_shed": n_shed,
            "shed_rate": n_shed / n_sub if n_sub else 0.0,
            "served_fraction": n_resp / n_sub if n_sub else 0.0,
            "latency_p50_ms": _pct(lat, 0.50) * 1e3,
            "latency_p99_ms": _pct(lat, 0.99) * 1e3,
            "version_lag_observed_max": lag["observed_max"],
            "version_lag_observed_mean": lag["observed_mean"],
            "version_lag_current_max": lag["current_max"],
            "head_version": lag["head_version"],
            "router": self.router.stats(),
            "admission": self.admission.stats(),
            "tap": self.tap.stats(),
            "replicas": [r.summary() for r in self.replicas],
        }
