"""Worker process: one `ServeEngine` behind two shared-memory rings.

The port's copy of the reference's ``cluster/proc/worker.py``.  Spawned
(never forked — a forked child cannot use CUDA once the parent has)
with a :class:`WorkerSpec` that carries everything needed to rebuild
the serving state deterministically:

- the `SystemConfig` and the device the parent system runs on (the
  worker builds on it; a worker that cannot reach CUDA reports
  ``("died", traceback)`` and the spawn raises — nothing falls back to
  the CPU),
- the path of the cell's saved base generation, opened via
  ``np.memmap`` so N workers map ONE physical copy of the postings,
- the path of the cell's saved query log and the rows appended since
  (the reference regenerates corpus and log from the config instead;
  the saved log skips that rebuild and carries the rows a live system
  appended before the spawn),
- the trained L1 parameters / state bins / Q-config (host arrays, see
  `messages.to_host`),
- the head policy snapshot and (live cells) the head index epoch at
  spawn time, applied before the first ticket is served.

The main loop mirrors `repro_torch.cluster.replica.Replica._run`: drain
control messages (policy/epoch relays — staleness is enforced HERE, by
the worker-local stores), pop request records off the inbound ring,
submit them with the same shed/retry semantics the thread replica uses,
flush when the ring runs dry (latency path) or step full buckets
otherwise, then push fixed-layout response records back.  The worker
also stamps a heartbeat and publishes its engine queue depth into the
ring header, which is the parent-side router's load signal.

Observability across the boundary: when the spec enables tracing, the
worker opens a ``worker`` span on the ticket's track (the trace-root
id rides the request record) and passes it to ``engine.submit`` so the
engine's queue/batch/execute/respond children land on the SAME
Perfetto row the parent's admit/ring spans live on.  Finished entries
ship as deltas piggybacked on stats replies (and a periodic
unsolicited stats message, which doubles as the freshness feed for
postmortem bundles); the parent rebases them with the clock offset it
measured from the ``ping``→``pong`` handshake at startup.  Each stats
reply also carries the worker's device, its rule-kernel launch count
(``kernel_launches``, set to 0 after a reply whose request asked for
a reset), its micro-batches' mean
``batch_inputs``/``execute`` times and, on a live cell, the generation
and directory of the base it serves from.

Control grammar, parent → worker: ``("policy", version, policies,
fallbacks)``, ``("epoch", version, generation, gen_dir, ops,
log_tail)``, ``("warmup",)``, ``("stats", seq, reset)``, ``("ping", t)``,
``("stop", drain)``; worker → parent: ``("ready", pid,
policy_version, index_epoch)``, ``("applied", what, version)``,
``("warmed", n)``, ``("stats", summary, metrics, trace_delta, seq)``
(``seq`` 0 on the unsolicited ones), ``("pong", t, t_worker)``,
``("stopped",)``, ``("died", traceback)``.  No message holds
a tensor.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serving.levels import ServiceLevel

from .messages import (REQUEST_BYTES, decode_request_block,
                       encode_response, from_host)
from .ring import RingClosed, ShmRing

__all__ = ["WorkerSpec", "worker_main"]

#: Per-iteration cap on ring pops — control messages and completions
#: must keep flowing under a request flood.
_DRAIN_LIMIT = 256
_IDLE_WAIT_S = 0.002
#: Unsolicited stats/trace cadence: keeps the parent's last-known
#: metrics + trace tail fresh enough that a SIGKILL's postmortem
#: bundle holds recent state, not just whatever stats() last pulled.
_STATS_INTERVAL_S = 1.0


@dataclasses.dataclass
class WorkerSpec:
    """Everything a worker needs to reconstruct its replica state (the
    reference's fields plus ``device``, ``log_path`` and ``log_tail``).
    Host values only: tensors travel as `messages.HostTensor`."""
    replica_idx: int
    sys_cfg: Any                      # repro_torch.system.SystemConfig
    base_dir: str                     # pristine corpus-built generation
    live: bool                        # follow relayed index epochs?
    capacity_docs: Optional[int]
    init_epoch: Optional[Tuple]       # (version, generation, gen_dir, ops)
    init_policy: Tuple                # (version, policies, fallbacks)
    l1_params: Any
    bins: Any
    qcfg: Any
    engine_cfg: Any                   # repro_torch.serving.EngineConfig
    policy_staleness_bound: int
    index_staleness_bound: int
    req_ring: Tuple[str, int, int]    # (shm name, n_slots, slot_bytes)
    resp_ring: Tuple[str, int, int]
    log_path: str                     # the cell's saved query log
    log_tail: Optional[Tuple]         # (q0, rows) appended since the save
    trace: bool = False               # record worker-side spans
    trace_capacity: int = 16384       # worker TraceLog ring size
    device: str = "cuda"              # the parent system's device


def worker_main(spec: WorkerSpec, conn) -> None:
    """Process entry point (spawn target — must be module-level)."""
    try:
        _serve(spec, conn)
    except BaseException:                         # noqa: BLE001
        # The parent's collector turns this into a respawn (or a shed
        # of the outstanding tickets once restarts are exhausted).
        try:
            conn.send(("died", traceback.format_exc()))
        except Exception:                         # noqa: BLE001
            pass
        raise
    finally:
        try:
            conn.close()
        except Exception:                         # noqa: BLE001
            pass


def _build_system(spec: WorkerSpec):
    # Imports happen here, inside the spawned child, so module import
    # of proc/ stays light in the parent.
    from repro_torch.device import resolve_device
    from repro_torch.index.live.segments import BaseSegment
    from repro_torch.system import RetrievalSystem

    from .follower import FollowerSystem, load_log

    device = resolve_device(spec.device)      # raises without CUDA
    log, idf = load_log(spec.log_path)
    if spec.live:
        system = FollowerSystem(
            spec.sys_cfg, spec.base_dir,
            capacity_docs=spec.capacity_docs,
            init_epoch=spec.init_epoch,
            staleness_bound=spec.index_staleness_bound,
            device=device, log=log, idf=idf)
    else:
        base = BaseSegment.load(spec.base_dir)    # np.memmap, shared
        system = RetrievalSystem(spec.sys_cfg, index=base.index,
                                 device=device, log=log)
        system.idf_all = idf
    if spec.log_tail is not None:
        system.extend_log(*spec.log_tail)
    # Trained artifacts travel with the spec — the worker must serve
    # with the parent's exact L1/bins, not retrain its own.
    system.l1_params = from_host(spec.l1_params, device)
    system.bins = from_host(spec.bins, device)
    system.qcfg = spec.qcfg
    return system


def _serve(spec: WorkerSpec, conn) -> None:
    from repro_torch.core.versioned import StaleVersionError
    from repro_torch.kernels.block_scan import BLOCK_SCAN_RULE_KERNEL
    from repro_torch.obs import NULL_TRACER, TraceLog, Tracer
    from repro_torch.policies import PolicyStore
    from repro_torch.serving import AdmissionError, CacheOnlyMiss, ServeEngine
    from repro_torch.serving.engine import (SLAB_ADMISSION_REJECT,
                                            SLAB_CACHED_ONLY_MISS)

    req = ShmRing.attach(*spec.req_ring)
    resp = ShmRing.attach(*spec.resp_ring)
    system = _build_system(spec)

    device = system.device
    store = PolicyStore(staleness_bound=spec.policy_staleness_bound)
    version, policies, fallbacks = spec.init_policy
    store.publish(from_host(policies, device),
                  fallbacks=from_host(fallbacks, device), version=version)
    tracer = (Tracer(log=TraceLog(capacity=spec.trace_capacity))
              if spec.trace else NULL_TRACER)
    engine = ServeEngine(system, store, spec.engine_cfg, tracer=tracer)
    keep = spec.engine_cfg.keep

    # engine rid -> (ticket id, qid, category, worker span): enough to
    # shed outstanding work explicitly when a batch poisons the engine.
    rid2ticket: Dict[int, Tuple[int, int, int, Any]] = {}
    retry: deque = deque()                        # stale-raced submissions
    stopping = False
    drain = True
    failures = 0
    max_failures = 3
    trace_cursor = 0

    def trace_delta() -> list:
        nonlocal trace_cursor
        if not tracer.enabled:
            return []
        entries, trace_cursor = tracer.log.drain_since(trace_cursor)
        return entries

    def stats_msg(seq: int = 0, reset: bool = False) -> tuple:
        summary = _summary(engine, system, BLOCK_SCAN_RULE_KERNEL, reset)
        return ("stats", summary, _metrics_with_rings(engine, req, resp),
                trace_delta(), seq)

    def shed(ticket_id: int, qid: int, category: int, reason: str,
             span=None) -> None:
        if span:
            span.end(error=reason)
        resp.push(encode_response(
            ticket_id, _mk_shed(qid, category, reason), keep))

    def shed_outstanding(reason: str) -> None:
        engine.cancel([rid for rid in rid2ticket])
        for rid, (tid, qid, category, span) in list(rid2ticket.items()):
            shed(tid, qid, category, reason, span)
        rid2ticket.clear()
        while retry:
            tid, qid, _level, category, span = retry.popleft()
            shed(tid, qid, category, reason, span)

    def submit_one(ticket_id: int, qid: int, level: ServiceLevel,
                   category: int, span=None) -> None:
        try:
            rid = engine.submit(qid, level, span=span)
        except AdmissionError:
            shed(ticket_id, qid, category, "replica_queue_full", span)
            return
        except CacheOnlyMiss:
            shed(ticket_id, qid, category, "cached_only_miss", span)
            return
        except StaleVersionError:
            # A relay raced between refresh and the staleness check —
            # retry after the next control drain applies the publish.
            retry.append((ticket_id, qid, level, category, span))
            return
        except Exception as e:                    # noqa: BLE001
            shed(ticket_id, qid, category,
                 f"replica_error:{type(e).__name__}", span)
            return
        rid2ticket[rid] = (ticket_id, qid, category, span)
        r = engine.take_response(rid)             # cache hits are inline
        if r is not None:
            push_response(rid, r)

    def submit_block(recs) -> None:
        """Slab submit for an untraced request block: one engine pass
        (vectorized admission + one slab span), per-record status
        reconciliation — same shed semantics as :func:`submit_one`."""
        try:
            rids, statuses = engine.submit_slab(
                recs["qid"], levels=recs["level"])
        except StaleVersionError:
            # Raised before any request id was assigned: the whole
            # block retries after the next control drain.
            for rec in recs:
                retry.append((int(rec["ticket"]), int(rec["qid"]),
                              ServiceLevel(int(rec["level"])),
                              int(rec["category"]), None))
            return
        except Exception:                         # noqa: BLE001
            # Per-record fallback isolates a poisoned request.
            for rec in recs:
                submit_one(int(rec["ticket"]), int(rec["qid"]),
                           ServiceLevel(int(rec["level"])),
                           int(rec["category"]))
            return
        done = []
        for i, rec in enumerate(recs):
            tid, qid, cat = (int(rec["ticket"]), int(rec["qid"]),
                             int(rec["category"]))
            st = int(statuses[i])
            if st == SLAB_ADMISSION_REJECT:
                shed(tid, qid, cat, "replica_queue_full")
            elif st == SLAB_CACHED_ONLY_MISS:
                shed(tid, qid, cat, "cached_only_miss")
            else:
                rid = int(rids[i])
                rid2ticket[rid] = (tid, qid, cat, None)
                r = engine.take_response(rid)     # cache hits are inline
                if r is not None:
                    done.append((rid, r))
        if done:
            push_responses(done)

    def push_response(rid: int, r) -> None:
        tid, _qid, _cat, span = rid2ticket.pop(rid)
        resp.push(encode_response(tid, r, keep))
        if span:
            # The worker span covers decode → response-on-ring; its
            # engine children (queue/batch/execute/respond) are already
            # in the log on the same ticket track.
            span.end(cached=r.cached, u=r.u)

    def push_responses(done: List[Tuple[int, Any]]) -> None:
        """Batch variant: B encoded responses cross the ring with one
        sequence-word publish (`ShmRing.push_many`)."""
        payloads, ended = [], []
        for rid, r in done:
            tid, _qid, _cat, span = rid2ticket.pop(rid)
            payloads.append(encode_response(tid, r, keep))
            if span:
                ended.append((span, r))
        resp.push_many(payloads)
        for span, r in ended:
            span.end(cached=r.cached, u=r.u)

    def handle_control(msg) -> None:
        nonlocal stopping, drain
        kind = msg[0]
        if kind == "policy":
            _, ver, pols, fbs = msg
            if ver > store.version:
                store.publish(from_host(pols, device),
                              fallbacks=from_host(fbs, device), version=ver)
            conn.send(("applied", "policy", store.version))
        elif kind == "epoch":
            _, ver, generation, gen_dir, ops, tail = msg
            if tail is not None:
                # The rows appended before this commit: a fresh query of
                # the epoch may arrive right after it.
                system.extend_log(*tail)
            head = system.apply_epoch(ver, generation, gen_dir, ops)
            conn.send(("applied", "epoch", head))
        elif kind == "warmup":
            conn.send(("warmed", engine.warmup()))
        elif kind == "stats":
            conn.send(stats_msg(msg[1], bool(msg[2])))
        elif kind == "ping":
            # Clock handshake: echo the parent's stamp alongside our
            # own clock reading; the parent halves the round trip and
            # keeps the minimum-RTT offset sample (NTP's trick).
            conn.send(("pong", msg[1], time.perf_counter()))
        elif kind == "stop":
            stopping, drain = True, bool(msg[1])

    conn.send(("ready", os.getpid(), engine.policy_version,
               engine.index_epoch))
    last_stats = time.monotonic()

    while True:
        progressed = False
        while conn.poll():
            handle_control(conn.recv())
            progressed = True
        if stopping and not drain:
            # Fast shutdown: abandon with explicit sheds, never serve.
            shed_outstanding("replica_shutdown")
            break
        raw = req.try_pop_records(_DRAIN_LIMIT, REQUEST_BYTES)
        if raw.shape[0]:
            progressed = True
            recs = decode_request_block(raw)
            if (raw.shape[0] > 1 and not tracer.enabled
                    and not recs["trace_root"].any()):
                submit_block(recs)                # slab fast path
            else:
                for rec in recs:
                    trace_root = int(rec["trace_root"])
                    span = (tracer.span("worker",
                                        track=f"ticket #{trace_root}",
                                        qid=int(rec["qid"]))
                            if trace_root and tracer.enabled else None)
                    submit_one(int(rec["ticket"]), int(rec["qid"]),
                               ServiceLevel(int(rec["level"])),
                               int(rec["category"]), span)
        if retry:
            batch = list(retry)
            retry.clear()
            for item in batch:
                submit_one(*item)
        try:
            if req.occupancy() == 0:
                engine.flush()                    # latency path
            else:
                engine.step()                     # full buckets only
            failures = 0
        except StaleVersionError:
            pass                                  # re-served after refresh
        except Exception as e:                    # noqa: BLE001
            failures += 1
            if failures >= max_failures:
                shed_outstanding(f"replica_error:{type(e).__name__}")
                failures = 0
        done = [(rid, r) for rid in list(rid2ticket)
                if (r := engine.take_response(rid)) is not None]
        if done:
            push_responses(done)
            progressed = True
        req.set_depth_hint(engine.queue_depth + engine.inflight
                           + len(retry))
        req.stamp_heartbeat()
        if time.monotonic() - last_stats >= _STATS_INTERVAL_S:
            # Unsolicited: keeps the parent's postmortem view fresh.
            conn.send(stats_msg())
            last_stats = time.monotonic()
        if (stopping and not rid2ticket and not retry
                and req.occupancy() == 0):
            break
        if not progressed:
            # Park on the control pipe: wakes instantly for relays,
            # times out quickly enough to poll the request ring.
            conn.poll(_IDLE_WAIT_S)

    # Final state for the parent: the post-mortem stats/metrics (and
    # the trace tail) the obs plane folds after the worker is gone.
    try:
        conn.send(stats_msg())
        conn.send(("stopped",))
    except Exception:                             # noqa: BLE001
        pass
    req.close()
    resp.close()


def _mk_shed(qid: int, category: int, reason: str):
    from repro_torch.cluster.admission import Shed
    return Shed(qid, category, 0.0, reason)


def _summary(engine, system, kernel, reset: bool = False) -> dict:
    """The engine's summary plus what the parent cannot see from its
    side of the boundary: the device, the L1 scoring sub-batch (sized by
    the device memory free in this process), the rule kernel's
    launches in this process (read, and with ``reset`` set to 0,
    between two tickets' work), the micro-batches' mean
    ``batch_inputs`` and ``execute`` times and, on a live cell, the
    base generation the head epoch serves from and its directory."""
    out = engine.summary()
    rows = list(engine.telemetry.batches)
    with kernel._lock:
        launches = {kernel.name: kernel.launches}
        if reset:
            kernel.launches = 0
    out.update(device=str(system.device),
               scoring_batch_size=system.scoring_batch_size(),
               kernel_launches=launches,
               n_timed_batches=len(rows),
               t_inputs_mean_s=(sum(b["t_inputs_s"] for b in rows) / len(rows)
                                if rows else None),
               t_execute_mean_s=(sum(b["t_execute_s"] for b in rows)
                                 / len(rows) if rows else None))
    store = getattr(system, "index_epoch_store", None)
    if store is not None:
        epoch = store.snapshot()
        path = epoch.view.base.path
        out.update(index_generation=epoch.generation,
                   index_gen_dir=None if path is None else str(path))
    return out


def _metrics_with_rings(engine, req: ShmRing, resp: ShmRing) -> dict:
    snap = engine.telemetry.registry.snapshot()
    # Ring contention counters ride the same mergeable snapshot: the
    # request ring's consumer side and the response ring's producer
    # side are this worker's (the parent owns the other two halves).
    for ring, ring_label in ((req, "req"), (resp, "resp")):
        for stat, v in ring.park_stats().items():
            snap[f"ring.{stat}{{ring={ring_label}}}"] = {
                "type": "counter", "value": int(v)}
        # Depth-style gauge: fleet ring occupancy sums across workers.
        snap[f"ring.occupancy{{ring={ring_label}}}"] = {
            "type": "gauge", "value": float(ring.occupancy()),
            "max": float(ring.occupancy()), "agg": "sum"}
    return snap
