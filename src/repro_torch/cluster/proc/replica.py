"""`ProcessReplica`: the parent-side handle of one worker process.

The port's copy of the reference's ``cluster/proc/replica.py``.
Protocol-compatible with `repro_torch.cluster.replica.Replica` — the
`ReplicaSet` talks to both through the same surface (enqueue / depth /
cache_has / warmup / metrics_snapshot / policy_version / index_epoch /
summary) and never notices which backend answers.  The differences
live behind that surface:

- tickets travel as fixed-layout records over a pair of SPSC
  shared-memory rings (`proc.ring` / `proc.messages`) — the enqueue
  hop is a memcpy, not a pickle;
- policy snapshots and index epochs are RELAYED over the worker's
  control pipe and applied by worker-local stores under the producer's
  version numbering (staleness is enforced worker-side);
- `cache_has` answers from a parent-side mirror: the (policy version,
  index epoch) each key's last response was produced under, checked
  against the worker's last-acked versions.  It is approximate the
  same way the thread replica's probe is — an eviction can race it,
  and the worker's `cached_only_miss` shed is the backstop;
- a dead worker (crash, SIGKILL) is respawned with FRESH rings and a
  fresh state snapshot, bounded by ``max_restarts`` (a relay either
  reaches that snapshot or follows it down the new pipe, see
  ``relay_mu``); outstanding tickets are requeued to the new worker, and
  `ClusterTicket.complete`'s first-wins contract absorbs any duplicate
  answer that slips through.  The parent owns the rings and unlinks
  them when it closes them, so a killed worker leaks none.

Every control message crosses the pipe as host values (policies through
`messages.to_host`): nothing the parent sends holds a tensor.  A worker
is started in two steps, :meth:`launch` (rings, pipe, process) and
:meth:`wait_ready` (the ready handshake), so that a fleet can start
every worker before it waits on any; :meth:`start` does both.
"""
from __future__ import annotations

import multiprocessing as mp
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Optional, Tuple

from repro_torch.cluster.admission import Shed
from repro_torch.cluster.replica import ClusterTicket, Result
from repro_torch.obs import NULL_TRACER, Tracer, adjust_remote_entries

from .messages import (REQUEST_BYTES, decode_response, encode_request,
                       encode_request_block, response_bytes, to_host)
from .ring import RingClosed, ShmRing

__all__ = ["ProcessReplica"]

_READY_TIMEOUT_S = 300.0      # child imports torch, reaches the device,
                              # loads the cell's log, maps the base
_REPLY_TIMEOUT_S = 600.0      # warmup prepares every serve step
_DEAD_DEPTH = 1 << 30         # router poison for an exhausted replica
_N_PINGS = 4                  # clock-handshake samples per (re)spawn
_TRACE_TAIL = 8192            # merged worker trace entries kept parent-side


class ProcessReplica:
    def __init__(self, idx: int, spec_factory: Callable,
                 on_complete: Optional[Callable[[ClusterTicket, Result], None]] = None,
                 *, keep: int, ring_slots: int = 64,
                 max_restarts: int = 2,
                 cache_mirror_capacity: int = 4096,
                 drain_timeout_s: float = 120.0,
                 tracer: Tracer = NULL_TRACER,
                 recorder=None):
        self.idx = idx
        self.spec_factory = spec_factory
        self.on_complete = on_complete
        self.keep = keep
        self.ring_slots = ring_slots
        self.max_restarts = max_restarts
        self.drain_timeout_s = drain_timeout_s
        self.tracer = tracer
        #: obs.FlightRecorder (optional): state-transition events plus
        #: the postmortem bundle written when a dead worker is salvaged.
        self.recorder = recorder

        # spawn, never fork: a forked child cannot use CUDA once the
        # parent has.
        self._mp = mp.get_context("spawn")
        self._proc: Optional[mp.process.BaseProcess] = None
        self._req: Optional[ShmRing] = None
        self._resp: Optional[ShmRing] = None
        self._conn = None

        self._mu = threading.Lock()
        self._conn_mu = threading.Lock()
        #: Held from a (re)spawn's spec capture to its process start, and
        #: by every relay: a relay published before the capture is in
        #: the spec, one after it goes down the new pipe (the worker reads
        #: it once ready), and none is dropped in between.  ``spec_factory``
        #: runs under it; an owner that keeps per-worker relay state
        #: (the log rows sent) updates it under it too.
        self.relay_mu = threading.RLock()
        self._outstanding: Dict[int, ClusterTicket] = {}
        self._next_tid = 0
        self._cache_mirror: "OrderedDict[object, Tuple[int, int]]" = \
            OrderedDict()
        self._mirror_cap = cache_mirror_capacity
        self._stopping = False
        self._dead = False                        # restarts exhausted
        self._worker_stopped = False
        self._policy_version = 0
        self._index_epoch = 0
        self._last_summary: dict = {}
        self._last_metrics: dict = {}
        # Stats requests are numbered; a reply carries its request's
        # number (0 on the unsolicited ones), so a caller waits for ITS
        # reply and not for one the worker sent before reading it.
        self._stats_cv = threading.Condition(self._mu)
        self._stats_seq = 0
        self._stats_ack = 0
        self._warm_evt = threading.Event()
        self._warm_result = 0
        self._pending_warmup = False
        # Chunk-kernel launches inside the worker processes: the current
        # worker's (from its last stats message, in pipe order) and
        # those of the workers that died (their last report).
        self._worker_launches: Dict[str, int] = {}
        self._dead_launches: Dict[str, int] = {}
        self._spawn_t0 = 0.0
        #: Seconds from each (re)spawn to its ready message, in order.
        self.spawn_seconds: list = []
        self._last_death: Optional[str] = None    # worker's last traceback
        self._collector: Optional[threading.Thread] = None
        self._collector_exit = threading.Event()
        # Cross-process trace collection: worker entry deltas arrive on
        # the control pipe and are rebased here — onto the parent clock
        # via the ping-handshake offset (min-RTT sample wins) and into
        # a per-worker id range so span ids never collide.
        self._clock_offset = 0.0
        self._offset_rtt = float("inf")
        self._trace_tail: deque = deque(maxlen=_TRACE_TAIL)
        self.last_bundle_path = None
        self.n_enqueued = 0
        self.n_completed = 0
        self.n_restarts = 0
        self.worker_pid: Optional[int] = None

    # ------------------------------------------------------------- control
    def start(self) -> "ProcessReplica":
        self.launch()
        return self.wait_ready()

    def launch(self) -> "ProcessReplica":
        """Create the rings and the pipe and spawn the worker; returns
        without waiting for it (see :meth:`wait_ready`)."""
        if self._proc is not None:
            raise RuntimeError(f"process replica {self.idx} already started")
        self._launch()
        return self

    def wait_ready(self) -> "ProcessReplica":
        """Block until the launched worker is ready, then start the
        collector thread."""
        self._await_ready()
        if self._collector is None:
            self._collector = threading.Thread(
                target=self._collect_loop, name=f"proc-replica-{self.idx}",
                daemon=True)
            self._collector.start()
        return self

    def _spawn(self) -> None:
        """Create rings + pipe, spawn the worker, block until ready."""
        self._launch()
        self._await_ready()

    def _launch(self) -> None:
        from .worker import worker_main
        with self.relay_mu:
            self._req = ShmRing.create(self.ring_slots, REQUEST_BYTES)
            self._resp = ShmRing.create(self.ring_slots,
                                        response_bytes(self.keep))
            parent_conn, child_conn = self._mp.Pipe()
            self._conn = parent_conn
            spec = self.spec_factory(
                self.idx,
                (self._req.name, self.ring_slots, REQUEST_BYTES),
                (self._resp.name, self.ring_slots, response_bytes(self.keep)))
            self._spawn_t0 = time.perf_counter()
            self._proc = self._mp.Process(
                target=worker_main, args=(spec, child_conn),
                name=f"replica-worker-{self.idx}", daemon=True)
            self._proc.start()
        child_conn.close()                        # parent keeps one end

    def _await_ready(self) -> None:
        deadline = time.monotonic() + _READY_TIMEOUT_S
        while True:
            if self._conn.poll(0.2):
                msg = self._conn.recv()
                if msg[0] == "ready":
                    _, pid, pv, epoch = msg
                    with self._mu:
                        self.worker_pid = pid
                        self._policy_version = pv
                        self._index_epoch = epoch
                        self._worker_stopped = False
                        # Fresh worker, fresh handshake: forget the old
                        # offset sample so a respawn re-estimates.
                        self._offset_rtt = float("inf")
                        self.spawn_seconds.append(
                            time.perf_counter() - self._spawn_t0)
                    if self.tracer.enabled:
                        # Clock handshake (async — pongs land in the
                        # collector): several samples, min RTT wins.
                        for _ in range(_N_PINGS):
                            self._send(("ping", time.perf_counter()))
                    if self._pending_warmup:
                        self._pending_warmup = False
                        self._send(("warmup",))   # fire-and-forget pre-start
                    return
                if msg[0] == "died":
                    raise RuntimeError(
                        f"replica {self.idx} worker died during spawn:\n"
                        f"{msg[1]}")
            elif not self._proc.is_alive():
                raise RuntimeError(
                    f"replica {self.idx} worker exited before ready "
                    f"(exitcode {self._proc.exitcode})")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {self.idx} worker not ready after "
                    f"{_READY_TIMEOUT_S}s")

    def stop(self, drain: bool = True) -> None:
        with self._mu:
            if self._stopping:
                return
            self._stopping = True
        if self._alive():
            self._send(("stop", bool(drain)))
            if drain:
                deadline = time.monotonic() + self.drain_timeout_s
                while time.monotonic() < deadline:
                    with self._mu:
                        if not self._outstanding and self._worker_stopped:
                            break
                    if not self._alive():
                        # Gone: what it sent is drained below.  (A
                        # pipe whose peer exited polls readable
                        # forever, so "no data left" never comes.)
                        break
                    time.sleep(0.005)
        self._collector_exit.set()
        if self._collector is not None:
            self._collector.join(timeout=30.0)
        self._drain_responses()
        self._drain_conn()
        self._shed_outstanding("replica_shutdown")
        if self._proc is not None:
            self._proc.join(timeout=10.0)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=10.0)
        self._close_channels()

    def _close_channels(self) -> None:
        for ring in (self._req, self._resp):
            if ring is not None:
                ring.close()
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass

    # -------------------------------------------------------------- ingest
    def enqueue(self, ticket: ClusterTicket) -> None:
        ticket.replica = self.idx
        tid = None
        with self._mu:
            if self._dead:
                reason = "replica_dead"
            elif self._stopping:
                reason = "replica_shutdown"
            else:
                reason = None
                tid = self._next_tid
                self._next_tid += 1
                self._outstanding[tid] = ticket
                self.n_enqueued += 1
        if tid is None:
            self._finish(ticket, Shed(ticket.qid, ticket.category,
                                      ticket.est_u, reason))
            return
        if ticket.inbox_span:
            # The parent cannot observe worker-side pickup; the inbox
            # span covers route → ring push instead.
            ticket.inbox_span.end()
            ticket.inbox_span = None
        trace_root = 0
        if ticket.span:
            # Trace context rides the data plane: the worker opens its
            # span on track ``ticket #<trace_root>``, so its engine
            # children join this ticket's Perfetto row.  The parent-side
            # ring span (push → response pop) encloses everything the
            # worker records, which keeps the merged stack nested even
            # before clock-offset correction.
            trace_root = ticket.span.span_id
            ticket.ring_span = ticket.span.child("ring", replica=self.idx)
        payload = encode_request(tid, ticket.qid, ticket.level,
                                 ticket.category, trace_root)
        try:
            self._req.push(payload, alive=self._alive)
        except (RingClosed, ValueError, TypeError):
            # Worker died (or rings are being swapped) mid-push: the
            # ticket stays outstanding and the respawn path requeues it
            # on the fresh ring — double answers are absorbed by the
            # ticket's first-completion-wins contract.
            pass

    def enqueue_many(self, tickets) -> None:
        """Batch ingest: register the whole group under one lock, pack
        it as a request slab, and cross the ring in whole-batch
        memcpys (`ShmRing.push_records`).  Same failure contract as
        :meth:`enqueue` — a mid-push death leaves the group
        outstanding for the respawn requeue."""
        if not tickets:
            return
        tids = []
        with self._mu:
            if self._dead:
                reason = "replica_dead"
            elif self._stopping:
                reason = "replica_shutdown"
            else:
                reason = None
                for ticket in tickets:
                    ticket.replica = self.idx
                    tid = self._next_tid
                    self._next_tid += 1
                    self._outstanding[tid] = ticket
                    tids.append(tid)
                self.n_enqueued += len(tickets)
        if reason is not None:
            for ticket in tickets:
                ticket.replica = self.idx
                self._finish(ticket, Shed(ticket.qid, ticket.category,
                                          ticket.est_u, reason))
            return
        roots = None
        for i, ticket in enumerate(tickets):
            if ticket.inbox_span:
                ticket.inbox_span.end()
                ticket.inbox_span = None
            if ticket.span:
                if roots is None:
                    roots = [0] * len(tickets)
                roots[i] = ticket.span.span_id
                ticket.ring_span = ticket.span.child("ring",
                                                     replica=self.idx)
        block = encode_request_block(
            tids, [t.qid for t in tickets],
            [int(t.level) for t in tickets],
            [t.category for t in tickets], roots)
        try:
            self._req.push_records(block, alive=self._alive)
        except (RingClosed, ValueError, TypeError):
            pass                      # respawn requeues the group

    def _finish(self, ticket: ClusterTicket, result: Result) -> None:
        if ticket.ring_span:
            # Ends at response pop (or shed): the parent-side cover for
            # everything the worker recorded about this ticket.
            ticket.ring_span.end()
            ticket.ring_span = None
        if not ticket.complete(result):
            return                    # a requeue's duplicate answer
        with self._mu:
            self.n_completed += 1
        if self.on_complete is not None:
            self.on_complete(ticket, result)

    def depth(self) -> int:
        """Router load signal: records still in the request ring plus
        the worker's last-published engine depth (ring header hint)."""
        with self._mu:
            if self._dead:
                return _DEAD_DEPTH
        req = self._req
        if req is None:
            return 0
        try:
            return req.occupancy() + req.depth_hint()
        except (RingClosed, ValueError, TypeError):
            return 0                  # ring mid-swap during a respawn

    # ----------------------------------------------------------- protocol
    @property
    def policy_version(self) -> int:
        with self._mu:
            return self._policy_version

    @property
    def index_epoch(self) -> int:
        with self._mu:
            return self._index_epoch

    def cache_has(self, base_key) -> bool:
        with self._mu:
            entry = self._cache_mirror.get(base_key)
            return (entry is not None
                    and entry == (self._policy_version, self._index_epoch))

    def warmup(self) -> int:
        if self._proc is None:
            # not started yet — the worker warms right after spawn
            self._pending_warmup = True
            return 0
        self._warm_evt.clear()
        self._send(("warmup",))
        if not self._warm_evt.wait(_REPLY_TIMEOUT_S):
            raise TimeoutError(f"replica {self.idx} warmup timed out")
        return self._warm_result

    def metrics_snapshot(self) -> dict:
        self._refresh_stats()
        with self._mu:
            return dict(self._last_metrics)

    def summary(self) -> dict:
        self._refresh_stats()
        with self._mu:
            out = dict(self._last_summary)
            out.update(replica=self.idx, backend="process",
                       n_enqueued=self.n_enqueued,
                       n_completed=self.n_completed,
                       n_restarts=self.n_restarts,
                       worker_pid=self.worker_pid,
                       depth=0)
        out["depth"] = self.depth()
        return out

    def _refresh_stats(self, reset: bool = False,
                       timeout_s: float = 10.0) -> bool:
        """Ask the worker for its stats and wait for the reply (``reset``
        sets its launch count to 0 once read); False when no worker is
        alive (its final pre-exit stats are cached) or none came."""
        if not self._alive():
            return False
        with self._mu:
            self._stats_seq += 1
            seq = self._stats_seq
        self._send(("stats", seq, bool(reset)))
        with self._mu:
            return self._stats_cv.wait_for(
                lambda: self._stats_ack >= seq, timeout_s)

    # -------------------------------------------------------------- relays
    def relay_policy(self, version: int, policies, fallbacks) -> bool:
        """Relay one policy snapshot (host values: the tensors inside
        ``policies``/``fallbacks`` travel as host arrays); False when
        no worker is alive to take it (the next spawn's spec carries
        the head instead)."""
        with self.relay_mu:
            if not self._alive():
                return False
            self._send(("policy", version, to_host(policies),
                        to_host(fallbacks)))
            return True

    def relay_epoch(self, version: int, generation: int, gen_dir: str,
                    ops, log_tail=None) -> bool:
        """Relay one index epoch, with the query-log rows appended
        before it (``follower.log_tail``; None when there are none);
        False, as :meth:`relay_policy`, when no worker is alive."""
        with self.relay_mu:
            if not self._alive():
                return False
            self._send(("epoch", version, generation, gen_dir, ops,
                        log_tail))
            return True

    # ------------------------------------------------------ kernel counts
    def kernel_launches(self, reset: bool = False,
                        timeout_s: float = 30.0) -> Dict[str, int]:
        """Kernel launches inside this replica's workers since the last
        reset: the live worker's count, asked for over the pipe (so it
        is current), plus the last count each dead worker reported.
        ``reset`` sets the counts to 0 once they are read."""
        if (self._alive()
                and not self._refresh_stats(reset=reset, timeout_s=timeout_s)):
            raise TimeoutError(f"replica {self.idx}: no launch count "
                               f"after {timeout_s}s")
        with self._mu:
            out = dict(self._dead_launches)
            for k, v in self._worker_launches.items():
                out[k] = out.get(k, 0) + v
            if reset:
                # Later stats messages count from the worker's reset on.
                self._dead_launches = {}
                self._worker_launches = {}
        return out

    # ----------------------------------------------------------- collector
    def _alive(self) -> bool:
        p = self._proc
        return p is not None and p.is_alive()

    def _send(self, msg) -> None:
        with self._conn_mu:
            try:
                self._conn.send(msg)
            except (OSError, BrokenPipeError):
                pass                  # death is handled by the collector

    def _conn_has_data(self) -> bool:
        try:
            return self._conn.poll()
        except (OSError, BrokenPipeError):
            return False

    def _collect_loop(self) -> None:
        while not self._collector_exit.is_set():
            progressed = self._drain_responses()
            progressed |= self._drain_conn()
            if not self._alive():
                with self._mu:
                    stopping = self._stopping
                if stopping:
                    if not progressed:
                        break         # stop() finishes the teardown
                else:
                    self._handle_death()
            if not progressed:
                time.sleep(0.001)

    def _drain_responses(self) -> bool:
        resp = self._resp
        if resp is None:
            return False
        progressed = False
        try:
            for payload in resp.try_pop_batch(limit=self.ring_slots):
                progressed = True
                tid, result = decode_response(payload)
                with self._mu:
                    ticket = self._outstanding.pop(tid, None)
                    if (ticket is not None and ticket.cache_key is not None
                            and not isinstance(result, Shed)):
                        self._mirror_record(ticket.cache_key,
                                            result.policy_version,
                                            result.index_epoch)
                    if not isinstance(result, Shed):
                        # Responses are the freshest version signal the
                        # parent has between control acks.
                        self._policy_version = max(self._policy_version,
                                                   result.policy_version)
                        self._index_epoch = max(self._index_epoch,
                                                result.index_epoch)
                if ticket is not None:
                    self._finish(ticket, result)
        except (RingClosed, ValueError, TypeError):
            pass                      # ring closed mid-swap
        return progressed

    def _mirror_record(self, cache_key, policy_version: int,
                       index_epoch: int) -> None:
        """Note the versions ``cache_key``'s last response was produced
        under (LRU, bounded at ``_mirror_cap``).  Caller holds _mu."""
        self._cache_mirror[cache_key] = (policy_version, index_epoch)
        self._cache_mirror.move_to_end(cache_key)
        while len(self._cache_mirror) > self._mirror_cap:
            self._cache_mirror.popitem(last=False)

    def _drain_conn(self) -> bool:
        progressed = False
        while self._conn_has_data():
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                break
            progressed = True
            self._on_message(msg)
        return progressed

    def _on_message(self, msg) -> None:
        """Apply one worker → parent control message (collector
        thread, in pipe order)."""
        kind = msg[0]
        if kind == "applied":
            _, what, version = msg
            with self._mu:
                if what == "policy":
                    self._policy_version = max(self._policy_version,
                                               version)
                else:
                    self._index_epoch = max(self._index_epoch, version)
        elif kind == "stats":
            _, summary, snap, trace_entries, seq = msg
            if trace_entries:
                self._ingest_trace(trace_entries)
            with self._mu:
                self._last_summary = summary
                self._last_metrics = snap
                self._worker_launches = dict(
                    summary.get("kernel_launches", {}))
                self._stats_ack = max(self._stats_ack, seq)
                self._stats_cv.notify_all()
        elif kind == "pong":
            # One clock-handshake sample: offset = midpoint of the
            # round trip minus the worker's stamp; the minimum-RTT
            # sample bounds the error by rtt/2 (NTP's estimator).
            _, t0, t_worker = msg
            t1 = time.perf_counter()
            rtt = t1 - t0
            with self._mu:
                if rtt < self._offset_rtt:
                    self._offset_rtt = rtt
                    self._clock_offset = (t0 + t1) / 2.0 - t_worker
        elif kind == "warmed":
            self._warm_result = msg[1]
            self._warm_evt.set()
        elif kind == "stopped":
            with self._mu:
                self._worker_stopped = True
        elif kind == "died":
            with self._mu:
                self._last_death = msg[1]

    def _handle_death(self) -> None:
        """The worker is gone without a drain-stop: salvage whatever it
        pushed before dying, then respawn with fresh rings and requeue
        the rest — or, past ``max_restarts``, shed them explicitly."""
        self._drain_responses()
        self._drain_conn()
        # Postmortem bundle FIRST, while the salvaged state (last stats
        # + trace tail + event ring + traceback) is still coherent.
        if self.recorder is not None:
            self.recorder.record(
                "worker_dead", replica=self.idx, worker_pid=self.worker_pid,
                n_restarts=self.n_restarts,
                n_outstanding=len(self._outstanding))
            self._dump_postmortem("worker_dead")
        with self._mu:
            if self.n_restarts >= self.max_restarts:
                self._dead = True
        if self._dead:
            if self.recorder is not None:
                self.recorder.record("replica_dead", replica=self.idx,
                                     n_restarts=self.n_restarts)
            self._shed_outstanding("replica_dead")
            return
        with self._mu:
            self.n_restarts += 1
            # The new worker starts with an empty cache; mirror entries
            # for the dead one must not price CACHED_ONLY admissions.
            self._cache_mirror.clear()
            # Its launches as last reported (those after its last stats
            # message are lost with it); the new worker counts from 0.
            for k, v in self._worker_launches.items():
                self._dead_launches[k] = self._dead_launches.get(k, 0) + v
            self._worker_launches = {}
        old_proc = self._proc
        self._close_channels()
        if old_proc is not None:
            old_proc.join(timeout=5.0)
        try:
            self._spawn()
        except Exception:                         # noqa: BLE001
            with self._mu:
                self._dead = True
            self._shed_outstanding("replica_dead")
            return
        if self.recorder is not None:
            self.recorder.record("worker_restart", replica=self.idx,
                                 worker_pid=self.worker_pid,
                                 n_restarts=self.n_restarts)
        # Requeue in ticket order; duplicate answers (the original
        # response raced the death detection) are absorbed by the
        # first-completion-wins ticket contract.
        with self._mu:
            pending = sorted(self._outstanding.items())
        for tid, ticket in pending:
            try:
                root = ticket.span.span_id if ticket.span else 0
                self._req.push(encode_request(tid, ticket.qid, ticket.level,
                                              ticket.category, root),
                               alive=self._alive)
            except RingClosed:
                return                # died again; next pass handles it

    def _shed_outstanding(self, reason: str) -> None:
        with self._mu:
            pending = list(self._outstanding.items())
            self._outstanding.clear()
        for _tid, ticket in pending:
            self._finish(ticket, Shed(ticket.qid, ticket.category,
                                      ticket.est_u, reason))

    # ---------------------------------------------------- observability
    def _ingest_trace(self, entries) -> None:
        """Rebase one worker trace delta into the parent's frame:
        shift onto the parent clock, move span ids into a per-worker
        range, and tag ticket-track entries with the worker pid (they
        must keep the parent's track name to share its Perfetto row)."""
        pid = self.worker_pid or 0
        with self._mu:
            dt = self._clock_offset
        adjusted = adjust_remote_entries(
            entries, dt=dt, id_offset=(pid & 0xFFFFFFFF) << 32,
            pid=pid, ticket_args={"wpid": pid})
        with self._mu:
            self._trace_tail.extend(adjusted)

    def trace_entries(self) -> list:
        """Rebased worker span entries (bounded tail, oldest first)."""
        with self._mu:
            return list(self._trace_tail)

    def clock_offset(self) -> Tuple[float, float]:
        """(offset_s, rtt_s) of the best handshake sample so far."""
        with self._mu:
            return self._clock_offset, self._offset_rtt

    def _dump_postmortem(self, reason: str):
        rec = self.recorder
        if rec is None:
            return None
        with self._mu:
            payload = {
                "reason": reason,
                "replica": self.idx,
                "backend": "process",
                "worker_pid": self.worker_pid,
                "n_restarts": self.n_restarts,
                "n_outstanding": len(self._outstanding),
                "death_traceback": self._last_death,
                "summary": dict(self._last_summary),
                "metrics": dict(self._last_metrics),
                "trace_tail": list(self._trace_tail),
            }
        path = rec.dump(f"postmortem-r{self.idx}", payload)
        if path is not None:
            self.last_bundle_path = path
        return path

    def health(self) -> dict:
        """Liveness + load signals for the statusz plane.  Heartbeat
        age comes from the ring header the worker stamps every loop
        (``time.monotonic`` — a system-wide clock, so parent-readable);
        ``pending`` folds ring occupancy with the worker's published
        engine depth so the watchdog can tell a parked idle consumer
        (stale heartbeat, nothing to do) from a wedged one."""
        with self._mu:
            dead = self._dead
            n_restarts = self.n_restarts
            pid = self.worker_pid
        alive = self._alive() and not dead
        h = {
            "backend": "process", "replica": self.idx, "alive": alive,
            "worker_pid": pid, "n_restarts": n_restarts,
            "heartbeat_age_s": None, "pending": 0,
        }
        req, resp = self._req, self._resp
        if req is not None and alive:
            try:
                hb = req.heartbeat()
                if hb > 0:
                    h["heartbeat_age_s"] = max(0.0, time.monotonic() - hb)
                occ = req.occupancy()
                hint = req.depth_hint()
                h["pending"] = occ + hint
                h["ring"] = {
                    "req_occupancy": occ, "depth_hint": hint,
                    "req": req.park_stats(),
                    "resp_occupancy": resp.occupancy(),
                    "resp": resp.park_stats(),
                }
            except (RingClosed, ValueError, TypeError):
                pass                  # ring mid-swap during a respawn
        return h
