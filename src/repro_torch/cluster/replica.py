"""One serving replica: a `ServeEngine` owned by a worker thread (the
port's copy of the reference's ``cluster/replica.py``, thread backend).

`ServeEngine` is single-threaded by design (submit/flush/take_response
mutate the batcher and cache without locks), so the replica gives each
engine exactly one driving thread and a thread-safe inbox in front of
it.  The worker drains the inbox into the engine, flushes when the
inbox runs dry (the latency path) and steps full buckets otherwise
(the throughput path), then fulfils cluster tickets from the engine's
completed responses.  Policy hot-swaps need no extra plumbing: the
engine refreshes to the store head on every submit/drain, so replicas
adopt new snapshots independently — the fleet may briefly serve mixed
versions, bounded by the store's staleness check.

A failed micro-batch is retried (the engine re-queues admitted
requests, FIFO preserved); after ``max_consecutive_failures`` the
replica fails its outstanding tickets with an explicit
:class:`~repro_torch.cluster.admission.Shed` rather than dropping them.
The same holds for any other exception a submit raises, a failing CUDA
kernel's included: it becomes a ``Shed`` with the reason
``replica_error:<type>``, the reference's semantics.  Callers that must
not mistake a fault for load (``chip_smoke.py``, ``launch/cluster.py
--smoke``) assert that no such shed occurred.

Every replica thread launches on the device's current stream, which
PyTorch keeps per thread and which is the same default stream for all
of them: kernels of several replicas (and the trainer) queue on one
stream, and each host sync of the rule loop waits for all of it.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional, Union

from repro_torch.core.versioned import StaleVersionError
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.serving import (AdmissionError, CacheOnlyMiss, EngineConfig,
                                 ServeEngine, ServiceLevel)
from repro_torch.serving.engine import (SLAB_ADMISSION_REJECT,
                                        SLAB_CACHED_ONLY_MISS, ServeResponse)
from repro_torch.serving.telemetry import Telemetry

from .admission import Shed

__all__ = ["ClusterTicket", "Replica"]

Result = Union[ServeResponse, Shed]


class ClusterTicket:
    """Cluster-level future for one submitted query."""

    def __init__(self, qid: int, category: int, est_u: float = 0.0,
                 cache_key=None,
                 level: ServiceLevel = ServiceLevel.FULL):
        self.qid = qid
        self.category = category
        self.est_u = est_u
        self.cache_key = cache_key
        self.level = level            # admission's ladder decision
        self.reserved_u = 0.0         # what the ledger holds for us
        self.replica: Optional[int] = None
        # Trace context (repro_torch.obs): the cluster opens ``span``
        # (the ticket's root) at admission and ends it at completion;
        # ``inbox_span`` covers route → replica-thread pickup (or, on
        # the process backend, route → ring push); ``ring_span`` is the
        # process backend's parent-side cover of the worker round trip
        # (ring push → response pop), which encloses every span the
        # worker records for this ticket.
        self.span = None
        self.inbox_span = None
        self.ring_span = None
        self.t_submit = Telemetry.now()
        self.t_done: Optional[float] = None
        # The Event is created LAZILY, only when a waiter arrives before
        # completion: on the cache-hot slab path nearly every ticket
        # completes inline at submit, and an eager Event costs an Event
        # + Condition + two locks + a waiter deque per ticket — pure
        # allocation/GC pressure that the ratio benches see directly.
        self._event: Optional[threading.Event] = None
        self._done = False
        self._done_lock = threading.Lock()
        self._result: Optional[Result] = None
        self._inbox_work = 0          # 1 while counted as a likely miss

    def complete(self, result: Result) -> bool:
        """Install the result; the FIRST completion wins.  Returns False
        for late duplicates — e.g. the original response of a ticket
        that was requeued after a worker death and already answered by
        the respawned worker.  Callers that do per-completion accounting
        (telemetry, tap records, ledger releases) must gate on the
        return value, or a retried ticket is double-counted."""
        with self._done_lock:
            if self._done:
                return False
            self.t_done = Telemetry.now()
            self._result = result
            self._done = True
            if self._event is not None:
                self._event.set()
            return True

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None) -> Optional[Result]:
        """The ServeResponse or Shed; None only on timeout."""
        if self._done:
            return self._result
        with self._done_lock:
            if self._done:
                return self._result
            ev = self._event
            if ev is None:
                ev = self._event = threading.Event()
        if not ev.wait(timeout):
            return None
        return self._result

    @property
    def shed(self) -> bool:
        return isinstance(self._result, Shed)

    @property
    def latency_s(self) -> float:
        if self.t_done is None:
            raise RuntimeError("ticket not completed yet")
        return self.t_done - self.t_submit


class Replica:
    def __init__(self, idx: int, system, store,
                 engine_cfg: EngineConfig = EngineConfig(),
                 on_complete: Optional[Callable[[ClusterTicket, Result], None]] = None,
                 max_consecutive_failures: int = 3,
                 poll_s: float = 0.005,
                 tracer: Tracer = NULL_TRACER):
        self.idx = idx
        self.engine = ServeEngine(system, store, engine_cfg, tracer=tracer)
        self.on_complete = on_complete
        self.max_consecutive_failures = max_consecutive_failures
        self.poll_s = poll_s
        self._inbox: deque = deque()
        self._inbox_work = 0          # likely-miss tickets in the inbox
        self._cond = threading.Condition()
        self._rid2ticket: Dict[int, ClusterTicket] = {}
        self._stopping = False
        self._abandon = False         # stop(drain=False): shed, don't serve
        self._thread: Optional[threading.Thread] = None
        self.n_enqueued = 0
        self.n_completed = 0

    # ------------------------------------------------------------- control
    def start(self) -> "Replica":
        if self._thread is not None:
            raise RuntimeError(f"replica {self.idx} already started")
        self._thread = threading.Thread(
            target=self._run, name=f"replica-{self.idx}", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` (default) everything already
        enqueued is served first, otherwise pending tickets are failed
        with an explicit Shed."""
        with self._cond:
            self._stopping = True
            self._abandon = not drain
            if not drain or self._thread is None:
                # no worker will ever drain these: shed, don't strand
                while self._inbox:
                    t = self._inbox.popleft()
                    self._inbox_work -= t._inbox_work
                    t._inbox_work = 0
                    self._finish(t, Shed(t.qid, t.category, t.est_u,
                                         "replica_shutdown"))
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()

    # -------------------------------------------------------------- ingest
    def enqueue(self, ticket: ClusterTicket) -> None:
        ticket.replica = self.idx
        # Work-weighted depth accounting: a ticket whose key is already
        # in this replica's result cache costs ~nothing (it completes
        # inline at submit), so only likely misses count toward the
        # router's load signal.
        # cache_has composes the engine's pinned (policy version, index
        # epoch) into the lookup — a stale-epoch entry is a miss here
        # exactly as it will be at submit.
        likely_hit = (ticket.cache_key is not None
                      and self.engine.cache_has(ticket.cache_key))
        with self._cond:
            if self._stopping:
                self._finish(ticket, Shed(ticket.qid, ticket.category,
                                          ticket.est_u, "replica_shutdown"))
                return
            if not likely_hit:
                ticket._inbox_work = 1
                self._inbox_work += 1
            self._inbox.append(ticket)
            self.n_enqueued += 1
            self._cond.notify()

    def enqueue_many(self, tickets) -> None:
        """Batch ingest: the likely-hit probes (engine-cache reads, safe
        under the GIL) run outside the lock, then the whole group lands
        in the inbox under ONE condition acquisition with ONE wake."""
        if not tickets:
            return
        for t in tickets:
            t.replica = self.idx
        likely = [t.cache_key is not None
                  and self.engine.cache_has(t.cache_key)
                  for t in tickets]
        with self._cond:
            if self._stopping:
                for t in tickets:
                    self._finish(t, Shed(t.qid, t.category, t.est_u,
                                         "replica_shutdown"))
                return
            for t, hit in zip(tickets, likely):
                if not hit:
                    t._inbox_work = 1
                    self._inbox_work += 1
                self._inbox.append(t)
            self.n_enqueued += len(tickets)
            self._cond.notify()

    def depth(self) -> int:
        """Router load signal in units of WORK, not requests: likely
        cache misses waiting in the inbox, plus everything queued or
        executing in the engine (queued engine requests are misses by
        construction — hits complete inline at submit).  Safe to call
        from the router thread: ``inflight`` is a plain int and
        ``queue_depth`` snapshots the batcher's queues before
        counting."""
        return self._inbox_work + self.engine.queue_depth + self.engine.inflight

    @property
    def policy_version(self) -> int:
        return self.engine.policy_version

    @property
    def index_epoch(self) -> int:
        return self.engine.index_epoch

    # Replica protocol (shared with cluster.proc.ProcessReplica): the
    # ReplicaSet talks to replicas only through these, never through
    # ``.engine`` directly — a process-backed replica has no in-process
    # engine to reach into.
    def cache_has(self, base_key) -> bool:
        return self.engine.cache_has(base_key)

    def warmup(self) -> int:
        return self.engine.warmup()

    def metrics_snapshot(self) -> dict:
        return self.engine.telemetry.registry.snapshot()

    def summary(self) -> dict:
        out = self.engine.summary()
        out.update(replica=self.idx, n_enqueued=self.n_enqueued,
                   n_completed=self.n_completed, depth=self.depth())
        return out

    def health(self) -> dict:
        """Statusz liveness signals, shape-compatible with
        `ProcessReplica.health` (``worker_pid``/``n_restarts`` are
        None/0 here).  A thread replica shares the parent's fault domain, so
        liveness is just the worker thread's and the heartbeat age is
        definitionally zero while it runs."""
        alive = self._thread is not None and self._thread.is_alive()
        return {
            "backend": "thread", "replica": self.idx, "alive": alive,
            "worker_pid": None, "n_restarts": 0,
            "heartbeat_age_s": 0.0 if alive else None,
            "pending": self.depth(),
        }

    def trace_entries(self) -> list:
        """Protocol parity with `ProcessReplica`: a thread replica's
        spans land directly in the shared tracer's log — nothing to
        merge."""
        return []

    # -------------------------------------------------------------- worker
    def _take_inbox(self):
        """Wait for work.  Returns (tickets, exit) — tickets may be
        empty on a timeout wake-up (used to re-try engine-queued work)."""
        with self._cond:
            if not self._inbox and (self._abandon or not self._rid2ticket):
                if self._stopping:
                    return [], True
                self._cond.wait(timeout=self.poll_s)
            tickets = list(self._inbox)
            self._inbox.clear()
            for t in tickets:
                self._inbox_work -= t._inbox_work
                t._inbox_work = 0
        return tickets, False

    def _submit_one(self, ticket: ClusterTicket) -> None:
        if ticket.inbox_span:
            ticket.inbox_span.end()
            ticket.inbox_span = None      # idempotent across retries
        try:
            rid = self.engine.submit(ticket.qid, ticket.level,
                                     span=ticket.span)
        except AdmissionError:
            self._finish(ticket, Shed(ticket.qid, ticket.category,
                                      ticket.est_u, "replica_queue_full"))
            return
        except CacheOnlyMiss:
            # An eviction raced the cluster's CACHED_ONLY routing
            # decision; there is no u reservation to roll out with, so
            # the ladder's last rung applies.
            self._finish(ticket, Shed(ticket.qid, ticket.category,
                                      ticket.est_u, "cached_only_miss"))
            return
        except StaleVersionError:
            # A publish (policy snapshot OR index epoch) raced between
            # the submit-time refresh and the staleness check; put the
            # ticket back and retry after the next refresh.
            with self._cond:
                ticket._inbox_work = 1
                self._inbox_work += 1
                self._inbox.appendleft(ticket)
            return
        except Exception as e:                    # noqa: BLE001
            # Any other submit failure must not kill the worker thread
            # (enqueue would keep feeding an undrained inbox): fail the
            # one ticket explicitly and keep serving.
            self._finish(ticket, Shed(ticket.qid, ticket.category,
                                      ticket.est_u,
                                      f"replica_error:{type(e).__name__}"))
            return
        self._rid2ticket[rid] = ticket
        resp = self.engine.take_response(rid)     # cache hits are inline
        if resp is not None:
            self._finish(self._rid2ticket.pop(rid), resp)

    def _submit_batch(self, tickets) -> None:
        """Feed a drained inbox group to the engine as ONE slab
        (`ServeEngine.submit_slab`): one refresh/validate, bulk cache
        probes and telemetry, per-ticket outcomes reconciled from the
        status array.  When tracing, each ticket's root span rides along
        (``spans=``): a miss gets its queue → batch → execute → respond
        children on its own track, as on the per-ticket path (which the
        reference takes when tracing; a hit here records no submit
        child)."""
        spans = None
        for t in tickets:
            if t.inbox_span:
                t.inbox_span.end()
                t.inbox_span = None
        if self.engine.tracer.enabled:
            spans = [t.span for t in tickets]
        try:
            rids, statuses = self.engine.submit_slab(
                [t.qid for t in tickets],
                levels=[int(t.level) for t in tickets], spans=spans)
        except StaleVersionError:
            # Same retry contract as the scalar path: back to the inbox
            # front, FIFO preserved, served after the next refresh.
            with self._cond:
                for t in reversed(tickets):
                    t._inbox_work = 1
                    self._inbox_work += 1
                    self._inbox.appendleft(t)
            return
        except Exception:                         # noqa: BLE001
            # Slab-level failure: fall back to per-ticket submits so a
            # single poisoned arrival sheds alone instead of taking the
            # whole group down with it.
            for t in tickets:
                self._submit_one(t)
            return
        for t, rid, status in zip(tickets, rids, statuses):
            if status == SLAB_ADMISSION_REJECT:
                self._finish(t, Shed(t.qid, t.category, t.est_u,
                                     "replica_queue_full"))
            elif status == SLAB_CACHED_ONLY_MISS:
                self._finish(t, Shed(t.qid, t.category, t.est_u,
                                     "cached_only_miss"))
            else:
                rid = int(rid)
                self._rid2ticket[rid] = t
                resp = self.engine.take_response(rid)   # inline hits
                if resp is not None:
                    self._finish(self._rid2ticket.pop(rid), resp)

    def _collect(self) -> None:
        for rid in list(self._rid2ticket):
            resp = self.engine.take_response(rid)
            if resp is not None:
                self._finish(self._rid2ticket.pop(rid), resp)

    def _finish(self, ticket: ClusterTicket, result: Result) -> None:
        if not ticket.complete(result):
            return                    # a retry already answered it
        self.n_completed += 1
        if self.on_complete is not None:
            self.on_complete(ticket, result)

    def _fail_outstanding(self, reason: str) -> None:
        rids = list(self._rid2ticket)
        # Also cancel them inside the engine: a failed batch was
        # requeued there, and leaving it would retry the same poisoned
        # FIFO-front batch forever (or, for transient failures, later
        # produce responses nobody claims).
        self.engine.cancel(rids)
        for rid in rids:
            t = self._rid2ticket.pop(rid)
            self._finish(t, Shed(t.qid, t.category, t.est_u, reason))

    def _run(self) -> None:
        failures = 0
        while True:
            tickets, exit_ = self._take_inbox()
            if exit_:
                if self._rid2ticket:
                    # stop(drain=False): work already inside the engine
                    # is abandoned with an explicit Shed, not served —
                    # a fast shutdown must not wait out rollouts.
                    self._fail_outstanding("replica_shutdown")
                break
            if len(tickets) > 1:
                self._submit_batch(tickets)
            else:
                for t in tickets:
                    self._submit_one(t)
            try:
                with self._cond:
                    inbox_empty = not self._inbox
                if inbox_empty:
                    self.engine.flush()           # latency path
                else:
                    self.engine.step()            # full buckets only
                failures = 0
            except StaleVersionError:
                # A publish (policy or index epoch) raced the drain past
                # the staleness bound; the engine re-queued the batch
                # and the next submit / flush serves it from the
                # refreshed head.
                continue
            except Exception as e:                # noqa: BLE001
                failures += 1
                if failures >= self.max_consecutive_failures:
                    self._fail_outstanding(f"replica_error:{type(e).__name__}")
                    failures = 0
                continue
            self._collect()
