"""The port's process cell (``repro_torch.cluster.proc``: shared-memory
rings, binary codecs, worker processes following the live index,
respawn, cross-process tracing) on the CPU: every case of
``tests/test_proc_cell.py`` but the two live-system cases
``tests/test_torch_live_index.py`` holds, the process cases of
``tests/test_hotpath.py`` and ``tests/test_obs.py``, ported case for
case, the process ``launch/cluster.py --smoke``, and four gates.

P1 holds the data plane byte for byte: the port's codecs give the
reference's bytes for the same requests, request blocks, OK and shed
responses, and refuse the same oversized response; a ring created by
either package is attached and drained by the other.

P2 holds the follower: a port ``FollowerSystem`` built in the test
process from a saved base plus the relayed ``(version, generation,
gen_dir, ops)`` of a port ``LiveRetrievalSystem`` (adds, base-doc
updates, commits, a merge) matches the JAX ``FollowerSystem`` on the
same files at every epoch — equal versions, bit-equal occupancy — and
its own ``check_epoch_parity``; its rollouts on both backends equal the
parent's at the same epoch, field for field.

P3 holds the fleet: a fresh 2-worker process cell and a fresh 2-replica
thread cell over one live system, one store and one stream (waves of
distinct keys served to completion, a spill margin wider than any
wave, so routing is timing-free) give equal ``ServeResponse``s in every
field but latency, per ticket and by slab, across a relayed policy
publish and a relayed epoch whose commit appended fresh queries; ids
and u equal ``test_torch_serving._direct``'s rollout.  With gate C2
(``tests/test_torch_cluster.py``: thread port = thread JAX), this holds
the process cell to the JAX package.

P4 holds the control plane: no spec and no control message in either
direction holds a ``torch.Tensor``, and policies, state bins and L1
parameters round-trip the host codec bit for bit.

Every comparison is exact.  Every wait has a timeout.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.cluster.admission import Shed as JShed
from repro.cluster.proc import FollowerSystem as JFollowerSystem
from repro.cluster.proc import ShmRing as JShmRing
from repro.cluster.proc import messages as jmessages
from repro.data.querylog import QueryLogConfig as JQueryLogConfig
from repro.index.corpus import CorpusConfig as JCorpusConfig
from repro.index.live.segments import DeltaOp as JDeltaOp
from repro.serving import ServiceLevel as JServiceLevel
from repro.serving.engine import ServeResponse as JServeResponse
from repro.system import SystemConfig as JSystemConfig
from repro_torch.cluster import ClusterConfig, ReplicaSet, Shed
from repro_torch.cluster.proc import (REQUEST_BYTES, FollowerSystem,
                                      ProcessReplica, ShmRing, decode_request,
                                      decode_response, encode_request,
                                      encode_response, from_host,
                                      response_bytes, to_host)
from repro_torch.cluster.proc import messages
from repro_torch.cluster.proc.follower import load_log, save_log
from repro_torch.cluster.proc.ring import RingClosed
from repro_torch.cluster.replica import ClusterTicket
from repro_torch.core.match_plan import plan_rollout
from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
from repro_torch.index.corpus import CorpusConfig
from repro_torch.index.live import (BaseSegment, LiveRetrievalSystem,
                                    check_epoch_parity)
from repro_torch.obs import Tracer
from repro_torch.policies import PolicyStore, TabularQPolicy
from repro_torch.serving import EngineConfig, ServiceLevel
from repro_torch.serving.cache import canonical_query_key
from repro_torch.serving.engine import ServeResponse
from repro_torch.system import SystemConfig
from test_obs import _load_checker
from test_torch_serving import _direct

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0
CAPACITY = 1536
LIVE = dict(n_docs=512, vocab=256, seed=5, n_queries=96, block_docs=128,
            p_bins=128, u_budget=512, l1_steps=60)


def _cfg(pkg_sys, pkg_corpus, pkg_log, p=LIVE):
    return pkg_sys(
        corpus=pkg_corpus(n_docs=p["n_docs"], vocab_size=p["vocab"],
                          seed=p["seed"]),
        querylog=pkg_log(n_queries=p["n_queries"], seed=p["seed"]),
        block_docs=p["block_docs"], p_bins=p["p_bins"],
        u_budget=p["u_budget"], l1_steps=p["l1_steps"])


def _q_policy(sys_, seed):
    """A seeded Q table whose stop column never wins, so a rollout runs
    several rules."""
    g = torch.Generator().manual_seed(seed)
    q = torch.rand((sys_.qcfg.p, sys_.qcfg.n_actions), generator=g)
    q[:, -1] = -1.0
    return TabularQPolicy(q)


def _policies(sys_, seed):
    return {cat: _q_policy(sys_, seed + cat) for cat in (CAT1, CAT2)}


def _store(sys_, seed=0, staleness_bound=4):
    store = PolicyStore(staleness_bound=staleness_bound)
    store.publish(_policies(sys_, seed), fallbacks=sys_.fallback_policies())
    return store


def _doc(rng, vocab=LIVE["vocab"]):
    return [np.unique(rng.integers(0, vocab, size=k)).astype(np.int32)
            for k in (1, 2, 8, 3)]


@pytest.fixture(scope="module")
def live():
    """One port live system (storage-less: the cell saves each
    generation under its own dir), L1 fitted, state bins fitted."""
    sys_ = LiveRetrievalSystem(_cfg(SystemConfig, CorpusConfig,
                                    QueryLogConfig),
                               capacity_docs=CAPACITY, device="cpu")
    sys_.fit_l1(n_queries=48, batch=16)
    sys_.fit_state_bins(n_queries=32, batch=16)
    return sys_


def _process_cell(sys_, store, tmp, n_replicas=2, tracer=None, **cfg_kw):
    ecfg = cfg_kw.pop("engine_cfg", EngineConfig(min_bucket=8, max_bucket=16,
                                                 cache_capacity=256))
    kw = {} if tracer is None else {"tracer": tracer}
    return ReplicaSet(sys_, store, ClusterConfig(
        n_replicas=n_replicas, backend="process", proc_storage_dir=str(tmp),
        **cfg_kw), ecfg, **kw)


@pytest.fixture(scope="module")
def cell(live, tmp_path_factory):
    """The shared untraced 2-worker cell (no test kills it), with its
    store."""
    store = _store(live)
    cluster = _process_cell(live, store, tmp_path_factory.mktemp("cell"))
    with cluster:
        yield cluster, store


# ------------------------------------------------------------------- rings
def test_ring_wraparound_preserves_fifo():
    """Sequence-number recycling survives several full laps of a tiny
    ring, interleaved full/empty conditions included."""
    ring = ShmRing.create(4, slot_bytes=16)
    try:
        sent = recvd = 0
        for lap in range(5):                   # 20 messages through 4 slots
            while ring.try_push(f"m{sent:04d}".encode()):
                sent += 1
            assert not ring.try_push(b"overflow")      # full: refused
            assert ring.occupancy() == 4
            while (msg := ring.try_pop()) is not None:
                assert msg == f"m{recvd:04d}".encode()  # strict FIFO
                recvd += 1
        assert sent == recvd == 20
        assert ring.try_pop() is None                   # empty: None
    finally:
        ring.close()


def test_ring_rejects_oversized_payload_before_write():
    ring = ShmRing.create(4, slot_bytes=8)
    try:
        with pytest.raises(ValueError, match="codec layer"):
            ring.try_push(b"x" * 9)
        assert ring.occupancy() == 0           # nothing partially written
        ring.push(b"x" * 8)                    # exactly slot_bytes is fine
        assert ring.try_pop() == b"x" * 8
    finally:
        ring.close()


def test_ring_park_counters_and_liveness():
    ring = ShmRing.create(2, slot_bytes=4)
    try:
        ring.push(b"a")
        ring.push(b"b")
        # full ring + dead peer: the producer parks, then bails out
        with pytest.raises(RingClosed):
            ring.push(b"c", alive=lambda: False)
        assert ring.park_stats()["producer_parks"] >= 1
        # drained ring + dead peer: the consumer parks, then bails out
        ring.try_pop(), ring.try_pop()
        with pytest.raises(RingClosed):
            ring.pop(alive=lambda: False)
        assert ring.park_stats()["consumer_parks"] >= 1
        ring.set_depth_hint(7)
        assert ring.depth_hint() == 7
        ring.stamp_heartbeat()
        assert ring.heartbeat() > 0
    finally:
        ring.close()


def test_ring_closed_raises():
    ring = ShmRing.create(2, slot_bytes=4)
    ring.close()
    with pytest.raises(RingClosed):
        ring.try_push(b"a")
    with pytest.raises(RingClosed):
        ring.try_pop()
    ring.close()                               # idempotent


class TestRingBatch:
    def test_roundtrip_and_wraparound_mid_batch(self):
        ring = ShmRing.create(8, 64)
        recs = np.arange(5 * 32, dtype=np.uint8).reshape(5, 32)
        assert ring.try_push_records(recs) == 5
        np.testing.assert_array_equal(ring.try_pop_records(16, 32), recs)
        # head=tail=5: a 5-record batch must split at the lap boundary
        # (3 slots to the wrap), never tear a record across it.
        k = ring.try_push_records(recs)
        assert k == 3
        got = ring.try_pop_records(16, 32)
        np.testing.assert_array_equal(got, recs[:3])
        k2 = ring.try_push_records(recs[3:])
        assert k2 == 2
        np.testing.assert_array_equal(ring.try_pop_records(16, 32), recs[3:])
        ring.close()

    def test_batch_larger_than_free_slots_splits_whole(self):
        import threading

        ring = ShmRing.create(8, 40)
        big = (np.arange(40, dtype=np.uint8)[None, :]
               + np.arange(30, dtype=np.uint8)[:, None])
        chunks = []
        deadline = time.monotonic() + 30.0

        def consume():
            while (sum(c.shape[0] for c in chunks) < 30
                   and time.monotonic() < deadline):
                got = ring.try_pop_records(4, 40)
                if got.shape[0]:
                    chunks.append(got)

        t = threading.Thread(target=consume)
        t.start()
        ring.push_records(big, deadline_s=time.monotonic() + 30.0)
        t.join(timeout=30.0)
        assert not t.is_alive()
        np.testing.assert_array_equal(np.concatenate(chunks), big)
        ring.close()

    def test_oversized_record_in_batch_rejected_cleanly(self):
        ring = ShmRing.create(8, 32)
        with pytest.raises(ValueError):
            ring.try_push_records(np.zeros((2, 100), np.uint8))
        with pytest.raises(ValueError):
            ring.try_push_many([b"ok", b"x" * 100])
        with pytest.raises(ValueError):
            ring.push_many([b"ok", b"x" * 100])
        # the sequence protocol survived: nothing was published
        assert ring.occupancy() == 0
        ring.push(b"alive")
        assert ring.pop(timeout_s=1.0) == b"alive"
        ring.close()

    def test_variable_length_batch_pop(self):
        ring = ShmRing.create(8, 32)
        ring.push_many([b"a", b"bb" * 8, b"c" * 3])
        assert ring.try_pop_batch() == [b"a", b"bb" * 8, b"c" * 3]
        # fixed-size pop refuses mixed lengths instead of mis-slicing
        ring.push_many([b"a" * 8, b"b" * 16])
        with pytest.raises(ValueError):
            ring.try_pop_records(8, 8)
        ring.close()

    def test_batched_park_wake_accounting(self):
        import threading

        ring = ShmRing.create(16, 32)
        recs = np.zeros((8, 32), np.uint8)
        got = []

        def consume():
            got.extend(ring.pop_batch(limit=16, timeout_s=30.0))

        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.15)                      # force the consumer to park
        ring.push_records(recs)
        t.join(timeout=30.0)
        stats = ring.park_stats()
        assert len(got) == 8
        # ONE park episode and ONE wake for the whole batch — not 8.
        assert stats["consumer_parks"] == 1
        assert stats["wakes"] == 1
        ring.close()


def test_watchdog_no_false_positive_on_idle_parked_ring():
    """A real ring whose consumer stopped stamping with nothing pending
    must classify parked_idle forever — never wedged."""
    from repro_torch.obs import HeartbeatWatchdog

    wd = HeartbeatWatchdog(stale_after_s=0.01, wedge_after_s=0.05)
    ring = ShmRing.create(4, slot_bytes=16)
    try:
        ring.stamp_heartbeat()                 # last sign of life
        ring.set_depth_hint(0)
        time.sleep(0.08)                       # way past wedge_after_s
        age = time.monotonic() - ring.heartbeat()
        pending = ring.occupancy() + ring.depth_hint()
        assert wd.assess(alive=True, heartbeat_age_s=age,
                         pending=pending) == "parked_idle"
        # the same silence WITH queued work is a wedge
        ring.push(b"x")
        pending = ring.occupancy() + ring.depth_hint()
        assert wd.assess(alive=True, heartbeat_age_s=age,
                         pending=pending) == "wedged"
    finally:
        ring.close()


# ------------------------------------------------------------------ codecs
def _response(cls=ServeResponse, level=ServiceLevel.SHALLOW):
    return cls(
        request_id=0, qid=42, category=1,
        doc_ids=np.array([5, 9, -1], np.int32),
        scores=np.array([2.5, 1.5, 0.0], np.float32),
        u=128, cand_cnt=17, cached=True, latency_s=0.25,
        policy_version=3, index_epoch=2, level=level)


def test_request_codec_roundtrip():
    payload = encode_request(77, 1234, ServiceLevel.SHALLOW, 2)
    assert len(payload) == REQUEST_BYTES
    # trace_root defaults to 0 = tracing off
    assert decode_request(payload) == (77, 1234, ServiceLevel.SHALLOW, 2, 0)
    # trace context (a 64-bit span id) rides the record unchanged
    root = (1 << 40) + 17
    payload = encode_request(77, 1234, ServiceLevel.FULL, 1, root)
    assert len(payload) == REQUEST_BYTES
    assert decode_request(payload) == (77, 1234, ServiceLevel.FULL, 1, root)


def test_response_codec_roundtrip_and_truncation_guard():
    r = _response()
    tid, back = decode_response(encode_response(9, r, keep=4))
    assert tid == 9 and back.qid == 42 and back.category == 1
    np.testing.assert_array_equal(back.doc_ids, r.doc_ids)
    np.testing.assert_array_equal(back.scores, r.scores)
    assert (back.u, back.cand_cnt, back.cached) == (128, 17, True)
    assert (back.policy_version, back.index_epoch) == (3, 2)
    assert back.level == ServiceLevel.SHALLOW
    assert back.latency_s == 0.25
    # a response wider than the ring slots were sized for must be
    # rejected at encode time, never silently truncated
    with pytest.raises(ValueError, match="keep"):
        encode_response(9, r, keep=2)


def test_shed_codec_roundtrip():
    shed = Shed(7, 1, 33.5, "replica_queue_full")
    tid, back = decode_response(encode_response(3, shed, keep=8))
    assert tid == 3 and isinstance(back, Shed)
    assert (back.qid, back.category) == (7, 1)
    assert back.est_u == 33.5
    assert back.reason == "replica_queue_full"
    # shed payloads fit the fixed header regardless of keep
    assert len(encode_response(3, shed, keep=0)) == response_bytes(0)


def test_request_block_codec_parity():
    from repro_torch.cluster.proc.messages import (decode_request_block,
                                                   encode_request_block)

    tids = [7, 8, 9]
    qids = [100, -1, 3]
    levels = [0, 1, 2]
    cats = [1, 2, 1]
    roots = [0, 0xDEAD, 0]
    block = encode_request_block(tids, qids, levels, cats, roots)
    assert block.shape == (3, REQUEST_BYTES)
    for i in range(3):
        scalar = encode_request(tids[i], qids[i], ServiceLevel(levels[i]),
                                cats[i], roots[i])
        assert bytes(block[i]) == scalar      # byte-for-byte the struct
        assert decode_request(bytes(block[i])) == (
            tids[i], qids[i], ServiceLevel(levels[i]), cats[i], roots[i])
    recs = decode_request_block(block)
    np.testing.assert_array_equal(recs["ticket"], tids)
    np.testing.assert_array_equal(recs["qid"], qids)
    np.testing.assert_array_equal(recs["level"], levels)
    np.testing.assert_array_equal(recs["category"], cats)
    np.testing.assert_array_equal(recs["trace_root"], roots)


# ------------------------------------------------- gate P1: the data plane
def test_gate_p1_codecs_byte_for_byte():
    """Requests, request blocks, OK and shed responses: the port's bytes
    are the reference's, and each package decodes the other's."""
    assert REQUEST_BYTES == jmessages.REQUEST_BYTES
    assert messages.REQ_DTYPE == jmessages.REQ_DTYPE
    assert response_bytes(100) == jmessages.response_bytes(100)
    root = (1 << 40) + 17
    for level in ServiceLevel:
        got = encode_request(77, -5, level, 1, root)
        want = jmessages.encode_request(77, -5, JServiceLevel(int(level)), 1,
                                        root)
        assert got == want
        assert jmessages.decode_request(got)[:2] == (77, -5)
    args = ([7, 8, 9], [100, -1, 3], [0, 1, 2], [1, 2, 1], [0, 0xDEAD, 0])
    np.testing.assert_array_equal(messages.encode_request_block(*args),
                                  jmessages.encode_request_block(*args))
    np.testing.assert_array_equal(messages.encode_request_block(*args[:4]),
                                  jmessages.encode_request_block(*args[:4]))
    for level in (ServiceLevel.FULL, ServiceLevel.SHALLOW):
        mine = encode_response(9, _response(level=level), keep=4)
        theirs = jmessages.encode_response(
            9, _response(JServeResponse, JServiceLevel(int(level))), keep=4)
        assert mine == theirs
        tid, back = decode_response(theirs)
        assert tid == 9 and back.level == level
        _, jback = jmessages.decode_response(mine)
        np.testing.assert_array_equal(jback.doc_ids, [5, 9, -1])
    for reason in ("replica_queue_full", "é" * 40):     # truncated at 48 B
        mine = encode_response(3, Shed(7, 1, 33.5, reason), keep=8)
        theirs = jmessages.encode_response(3, JShed(7, 1, 33.5, reason),
                                           keep=8)
        assert mine == theirs
    with pytest.raises(ValueError, match="keep"):
        encode_response(9, _response(), keep=2)
    with pytest.raises(ValueError, match="keep"):
        jmessages.encode_response(9, _response(JServeResponse), keep=2)


@pytest.mark.parametrize("maker", ["port", "reference"])
def test_gate_p1_ring_attached_across_packages(maker):
    """A ring made by one package is attached by the other and carries
    records both ways (one ring per direction, as a replica's): the
    batch paths across the wrap, the scalar and variable-length paths,
    and the header words each side reads of the other's."""
    mk, other = (ShmRing, JShmRing) if maker == "port" else (JShmRing,
                                                              ShmRing)
    req = mk.create(8, 64)                   # peer produces, owner drains
    resp = mk.create(8, 64)                  # owner produces, peer drains
    req_peer = other.attach(req.name, 8, 64)
    resp_peer = other.attach(resp.name, 8, 64)
    try:
        recs = np.arange(6 * 40, dtype=np.uint8).reshape(6, 40)
        splits = 0
        for lap in range(4):                  # 24 records through 8 slots
            done, got = 0, []
            while done < 6:
                k = req_peer.try_push_records(recs[done:])
                assert k > 0
                splits += k < 6 - done        # stopped at the wrap
                done += k
                got.append(req.try_pop_records(16, 40))
            np.testing.assert_array_equal(np.concatenate(got), recs)
        assert splits >= 1
        req_peer.push(b"x" * 64)
        assert req.pop(timeout_s=1.0) == b"x" * 64
        resp.push_many([b"a", b"bb" * 8])
        assert resp_peer.try_pop_batch() == [b"a", b"bb" * 8]
        resp.push(b"c")
        assert resp_peer.pop(timeout_s=1.0) == b"c"
        req_peer.stamp_heartbeat()
        req_peer.set_depth_hint(5)
        assert req.heartbeat() == req_peer.heartbeat() > 0
        assert req.depth_hint() == 5
        assert req.occupancy() == resp_peer.occupancy() == 0
        assert req.park_stats() == req_peer.park_stats()
    finally:
        for ring in (req_peer, resp_peer, req, resp):
            ring.close()


# --------------------------------------------- telemetry double-count
def test_ticket_complete_is_first_wins():
    """A requeued ticket can receive two answers (the original raced
    the death detection); only the first completion may count."""
    t = ClusterTicket(1, 0)
    r1 = ServeResponse(0, 1, 0, np.zeros(1, np.int32),
                       np.zeros(1, np.float32), 1, 1, False, 0.0)
    assert t.complete(r1) is True
    assert t.complete(Shed(1, 0, 0.0, "late duplicate")) is False
    assert t.result() is r1                    # first answer sticks


def test_duplicate_answer_not_double_counted():
    """ProcessReplica._finish gates bookkeeping AND the cluster
    callback on the ticket's first-completion."""
    seen = []
    pr = ProcessReplica(0, spec_factory=None,
                        on_complete=lambda t, r: seen.append(r), keep=4)
    t = ClusterTicket(5, 0)
    resp = ServeResponse(0, 5, 0, np.zeros(1, np.int32),
                         np.zeros(1, np.float32), 1, 1, False, 0.0)
    pr._finish(t, resp)
    pr._finish(t, resp)                        # the requeue's duplicate
    assert pr.n_completed == 1
    assert len(seen) == 1


def test_process_replica_mirror_bounded():
    r = ProcessReplica(0, spec_factory=None, keep=8,
                       cache_mirror_capacity=16)
    for i in range(100):
        with r._mu:
            r._mirror_record(("key", i), policy_version=1, index_epoch=0)
    assert len(r._cache_mirror) == 16
    # LRU: the newest keys survive
    assert ("key", 99) in r._cache_mirror
    assert ("key", 0) not in r._cache_mirror
    with r._mu:
        r._policy_version, r._index_epoch = 1, 0
    assert r.cache_has(("key", 99))
    assert not r.cache_has(("key", 0))


# ----------------------------------------------------- cross-process trace
def _assert_trace_doc_wellformed(doc):
    evs = [e for e in doc["traceEvents"] if e["ph"] in ("B", "E")]
    stacks = {}
    for ev in evs:
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev["name"])
        else:
            assert stacks.get(key), f"E without B on {key}"
            assert stacks[key].pop() == ev["name"], "bad nesting"
    assert all(not s for s in stacks.values()), "unclosed B at EOF"
    last = {}
    for ev in evs:
        key = (ev["pid"], ev["tid"])
        assert ev["ts"] >= last.get(key, float("-inf")), "non-monotone"
        last[key] = ev["ts"]


@settings(deadline=None, max_examples=40)
@given(st.floats(-3.0, 3.0, allow_nan=False),
       st.floats(0.0, 0.2, allow_nan=False))
def test_clock_skew_alignment_property(err, jitter):
    """Whatever the residual clock-offset estimation error — including
    skews large enough to push the worker's spans entirely outside (or
    onto the exact boundaries of) the parent-side ring span — rebasing
    with adjust_remote_entries and exporting the merged timeline yields
    monotone, properly nested B/E stacks."""
    from repro_torch.obs import adjust_remote_entries, export_chrome_entries

    parent = Tracer(clock=lambda: 0.0)
    t = parent.root_span("ticket")
    t.t0 = 0.0
    ring = t.child("ring")
    ring.t0 = 2.0
    true_offset = 37.0                 # worker = parent - true_offset
    wtr = Tracer(clock=lambda: 0.0)
    w = wtr.span("worker", track=t.track)
    w.t0 = 3.0 + jitter - true_offset
    ex = wtr.span("execute", track=t.track, parent=w)
    ex.t0 = 4.0 - true_offset
    ex.end(t1=6.0 - true_offset)
    w.end(t1=7.0 - jitter - true_offset)
    ring.end(t1=8.0)
    t.end(t1=10.0)
    entries = parent.log.snapshot() + adjust_remote_entries(
        wtr.log.snapshot(), dt=true_offset + err,
        id_offset=7 << 32, pid=7, ticket_args={"wpid": 7})
    ids = [e["id"] for e in entries if e["id"] is not None]
    assert len(ids) == len(set(ids)), "id collision after offsetting"
    doc = export_chrome_entries(entries)
    _assert_trace_doc_wellformed(doc)
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] != "M"}
    assert len(tids) == 1              # everything on the one ticket row


def test_trace_drain_since_ships_deltas_and_skips_evicted():
    from repro_torch.obs import TraceLog

    tracer = Tracer(log=TraceLog(capacity=4))
    for i in range(3):
        tracer.span(f"s{i}", track="w").end()
    first, cur = tracer.log.drain_since(0)
    assert [e["name"] for e in first] == ["s0", "s1", "s2"] and cur == 3
    for i in range(3, 9):
        tracer.span(f"s{i}", track="w").end()
    later, cur = tracer.log.drain_since(cur)
    assert [e["name"] for e in later] == ["s5", "s6", "s7", "s8"]
    assert cur == 9 and tracer.log.drain_since(cur) == ([], 9)


# ------------------------------------------------------ the shared cell
def test_process_backend_bit_parity_with_thread(live, cell):
    """Responses through worker processes are bit-identical to the
    thread backend AND to the single-host reference rollout."""
    cluster, store = cell
    rng = np.random.default_rng(4)
    qids = rng.integers(0, LIVE["n_queries"], size=24)
    proc = cluster.serve(list(qids), timeout_s=TIMEOUT_S)
    stats = cluster.stats()
    pids = {s["worker_pid"] for s in stats["replicas"]}
    assert len(pids) == 2 and os.getpid() not in pids
    assert {s["device"] for s in stats["replicas"]} == {"cpu"}
    thread = ReplicaSet(live, store, ClusterConfig(n_replicas=2),
                        EngineConfig(min_bucket=8, max_bucket=16,
                                     cache_capacity=256))
    with thread:
        thr = thread.serve(list(qids), timeout_s=TIMEOUT_S)
    ids, sc, u = _direct(live, store.snapshot().policies, qids)
    for lane, (t, p) in enumerate(zip(thr, proc, strict=True)):
        assert not isinstance(t, Shed) and not isinstance(p, Shed)
        assert t.qid == p.qid == qids[lane]
        np.testing.assert_array_equal(p.doc_ids, t.doc_ids)
        np.testing.assert_array_equal(p.scores, t.scores)
        assert p.u == t.u == u[lane]
        np.testing.assert_array_equal(p.doc_ids, ids[lane])
        np.testing.assert_array_equal(p.scores, sc[lane])
        assert p.policy_version == store.version


def test_cluster_process_slab_parity(live, cell):
    """The slab front door through worker processes: the thread oracle's
    strong fields, zero sheds, the hot round served from worker
    caches."""
    cluster, store = cell
    qids = list(range(24))
    proc = [cluster.serve_many(qids, timeout_s=TIMEOUT_S) for _ in range(2)]
    thread = ReplicaSet(live, store, ClusterConfig(n_replicas=2),
                        EngineConfig(min_bucket=8, max_bucket=16,
                                     cache_capacity=256))
    with thread:
        loop = [thread.serve(qids, timeout_s=TIMEOUT_S) for _ in range(2)]
    for rm, rl in zip(proc, loop):
        for a, b in zip(rm, rl, strict=True):
            assert not isinstance(a, Shed)
            assert a.qid == b.qid and a.u == b.u
            assert a.cand_cnt == b.cand_cnt
            np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
            np.testing.assert_array_equal(a.scores, b.scores)
    assert all(r.cached for r in proc[1])      # second round is hot


def test_process_cell_metrics_fold_worker_registries(cell):
    """Per-process registry snapshots (engine instruments + ring
    contention counters) merge through the existing fold."""
    cluster, _ = cell
    cluster.serve(list(range(8)), timeout_s=TIMEOUT_S)
    keys = set(cluster.metrics_snapshot())
    assert any(k.startswith("serve.requests") for k in keys)
    assert any(k.startswith("ring.occupancy") for k in keys)
    assert any(k.startswith("ring.consumer_parks") for k in keys)
    assert any(k.startswith("cluster.submitted") for k in keys)
    doc = cluster.statusz()
    assert doc["backend"] == "process" and doc["cell_dir"]
    assert all(r["ring"]["req"]["consumer_parks"] >= 0
               for r in doc["replicas"])


# ------------------------------------------------------ gate P3: the fleet
def _distinct_keys(sys_, qids):
    """qids with pairwise distinct canonical keys, in order."""
    seen, out = set(), []
    for q in qids:
        key = canonical_query_key(sys_.log.terms[q], int(sys_.log.category[q]))
        if key not in seen:
            seen.add(key)
            out.append(int(q))
    return out


def _assert_same(a, b):
    """Every ServeResponse field but latency."""
    assert not isinstance(a, Shed) and not isinstance(b, Shed)
    for f in dataclasses.fields(ServeResponse):
        if f.name == "latency_s":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, (f.name, x, y)


def _await_acks(cluster, version, epoch):
    """Block until every worker acked ``version`` and ``epoch`` (relays
    are asynchronous; a thread replica reads the head at its next
    submit)."""
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        if (min(cluster.version_lag()["replica_versions"]) >= version
                and min(r.index_epoch for r in cluster.replicas) >= epoch):
            return
        time.sleep(0.01)
    raise AssertionError(f"workers did not ack v{version} / e{epoch}")


def test_gate_p3_process_cell_equals_thread_cell_across_relays(live,
                                                               tmp_path):
    store = _store(live, seed=10)
    ecfg = EngineConfig(min_bucket=8, max_bucket=16, cache_capacity=256)
    proc = _process_cell(live, store, tmp_path, engine_cfg=ecfg,
                         spill_margin=64)
    thread = ReplicaSet(live, store, ClusterConfig(n_replicas=2,
                                                   spill_margin=64), ecfg)
    rng = np.random.default_rng(12)
    head = _distinct_keys(live, rng.permutation(live.log.n_queries))
    e0 = live.index_epoch
    got = {"proc": [], "thread": []}

    def wave(qids, slab):
        _await_acks(proc, store.version, live.index_epoch)
        start = len(got["proc"])
        for name, c in (("proc", proc), ("thread", thread)):
            got[name].extend(c.serve_many(qids, timeout_s=TIMEOUT_S) if slab
                             else c.serve(qids, timeout_s=TIMEOUT_S))
        return got["proc"][start:]

    def check_direct(results, qids):
        ids, sc, u = _direct(live, store.snapshot().policies, qids)
        for r, i, s_, uu in zip(results, ids, sc, u, strict=True):
            np.testing.assert_array_equal(r.doc_ids, i)
            np.testing.assert_array_equal(r.scores, s_)
            assert r.u == uu and r.policy_version == store.version
            assert r.index_epoch == live.index_epoch

    with proc, thread:
        check_direct(wave(head[:20], slab=False), head[:20])   # misses
        wave(head[:8] + head[20:28], slab=True)                # hits + misses
        # a relayed policy publish: the versioned keys retire the hits
        store.publish(_policies(live, seed=20))
        check_direct(wave(head[:16], slab=True), head[:16])
        # a relayed epoch whose commit appended fresh queries first
        docs = [_doc(rng) for _ in range(6)]
        new_ids = live.add_documents(docs, static_rank=[0.01] * 6)
        fresh = live.append_queries([d[2][:3] for d in docs], [CAT2] * 6,
                                    judged_ids=[[i] for i in new_ids],
                                    judged_gains=[[4]] * 6)
        live.commit_index()
        tail = _distinct_keys(live, [int(q) for q in fresh] + head[28:34])
        assert max(tail) >= LIVE["n_queries"]                  # fresh ones
        check_direct(wave(tail, slab=False), tail)
        wave(tail + head[:4], slab=True)
        pstats, tstats = proc.stats(), thread.stats()
    assert len(got["proc"]) == len(got["thread"]) == 20 + 16 + 16 + 2 * len(
        tail) + 4
    for a, b in zip(got["proc"], got["thread"], strict=True):
        _assert_same(a, b)
    assert {r.index_epoch for r in got["proc"]} == {e0, e0 + 1}
    assert {r.policy_version for r in got["proc"]} == {1, 2}
    assert sum(r.cached for r in got["proc"]) >= 8 + len(tail)
    for k in ("n_submitted", "n_responses", "n_shed",
              "replica_index_epochs"):
        assert pstats[k] == tstats[k], k
    assert [r["n_enqueued"] for r in pstats["replicas"]] == \
        [r["n_enqueued"] for r in tstats["replicas"]]


def test_stale_policy_relay_is_skipped_not_applied(live, tmp_path):
    """Control-channel ordering: a worker applies publishes
    monotonically — a late v_old relay after v_new must be a no-op (the
    worker-local store enforces publish-if-newer)."""
    store = _store(live)
    cluster = _process_cell(live, store, tmp_path, n_replicas=1,
                            engine_cfg=EngineConfig(min_bucket=8, max_bucket=8,
                                                    cache_capacity=0))
    with cluster:
        replica = cluster.replicas[0]
        snap = store.snapshot()
        pols, fbs = dict(snap.policies), dict(snap.fallbacks)
        replica.relay_policy(5, pols, fbs)     # future version
        replica.relay_policy(3, pols, fbs)     # stale: must be skipped
        deadline = time.monotonic() + 60.0
        while replica.policy_version < 5 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert replica.policy_version == 5
        res = cluster.serve([0, 1, 2, 3], timeout_s=TIMEOUT_S)
        assert not any(isinstance(r, Shed) for r in res)
        assert all(r.policy_version == 5 for r in res)


def test_worker_without_cuda_dies_and_the_spawn_raises(live, tmp_path):
    """A worker builds on the device its spec names and never falls
    back: told ``cuda`` on a machine without it, it reports its
    traceback and the spawn raises; stopping the cell unlinks the
    rings it made."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    cluster = _process_cell(live, _store(live), tmp_path, n_replicas=1)
    replica = cluster.replicas[0]
    factory = replica.spec_factory
    replica.spec_factory = lambda *a: dataclasses.replace(factory(*a),
                                                          device="cuda")
    with pytest.raises(RuntimeError, match="died during spawn(.|\n)*CUDA"):
        cluster.start()
    rings = (replica._req.name, replica._resp.name)
    cluster.stop()
    for name in rings:
        assert not Path("/dev/shm", name.lstrip("/")).exists()


# ---------------------------------- the traced cell: trace, then P4
@pytest.fixture(scope="module")
def traced(live, tmp_path_factory):
    """A traced 2-worker cell whose spec and control messages (both
    directions) are recorded, for the trace case and gate P4."""
    store = _store(live, seed=30)
    cluster = _process_cell(live, store, tmp_path_factory.mktemp("traced"),
                            tracer=Tracer(),
                            engine_cfg=EngineConfig(min_bucket=8,
                                                    max_bucket=8,
                                                    cache_capacity=0))
    box = []
    for r in cluster.replicas:
        send, on_msg, factory = r._send, r._on_message, r.spec_factory

        def rec_send(msg, send=send):
            box.append(("out", msg))
            send(msg)

        def rec_on(msg, on_msg=on_msg):
            box.append(("in", msg))
            on_msg(msg)

        def rec_spec(*a, factory=factory):
            spec = factory(*a)
            box.append(("spec", spec))
            return spec

        r._send, r._on_message, r.spec_factory = rec_send, rec_on, rec_spec
    with cluster:
        yield cluster, store, box


def test_process_cell_merged_trace_cross_pid(live, traced, tmp_path):
    """Trace context rides the ring request structs into the workers,
    worker spans ship back as deltas, and the parent merges everything
    into ONE timeline — at least one ticket must carry the full admit ->
    ring -> worker -> execute -> respond chain across the process
    boundary, with worker spans from >= 2 distinct pids."""
    cluster, _, _ = traced
    rng = np.random.default_rng(11)
    results = cluster.serve(rng.integers(0, LIVE["n_queries"], size=24),
                            timeout_s=TIMEOUT_S)
    assert not any(isinstance(r, Shed) for r in results)
    for r in cluster.replicas:             # the ping handshake landed
        offset, rtt = r.clock_offset()
        assert rtt < 10.0 and abs(offset) < 10.0

    def merged_worker_pids():
        wpids = set()
        for e in cluster.trace_entries():
            if str(e["track"]).startswith("ticket #") \
                    and e["name"] == "worker":
                wpids.add((e["args"] or {}).get("wpid"))
        wpids.discard(None)
        return wpids

    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        cluster.stats()
        if len(merged_worker_pids()) >= 2:
            break
        time.sleep(0.05)
    worker_pids = merged_worker_pids()
    assert len(worker_pids) >= 2, f"worker spans from {worker_pids}"
    assert os.getpid() not in worker_pids
    doc = cluster.statusz()
    assert doc["backend"] == "process" and doc["state"] != "dead"
    assert {r["worker_pid"] for r in doc["replicas"]} >= worker_pids
    for r in doc["replicas"]:
        assert r["state"] in ("healthy", "parked_idle", "busy")
    path = tmp_path / "proc_trace.json"
    assert cluster.write_trace(path) > 0
    out = _load_checker().check_trace(str(path), require_chain=False,
                                      require_proc_chain=True)
    assert out["n_proc_chain_tickets"] >= 1
    assert len(out["worker_pids"]) >= 2
    assert str(out["example_proc_chain_track"]).startswith("ticket #")


def _tensors_in(obj, path="msg"):
    """Paths of every torch.Tensor inside ``obj``."""
    if isinstance(obj, torch.Tensor):
        return [path]
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in _tensors_in(v, f"{path}[{k!r}]")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in _tensors_in(v, f"{path}[{i}]")]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [p for f in dataclasses.fields(obj)
                for p in _tensors_in(getattr(obj, f.name), f"{path}.{f.name}")]
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return [p for k, v in vars(obj).items()
                for p in _tensors_in(v, f"{path}.{k}")]
    return []


def test_gate_p4_control_plane_holds_no_tensor(live, traced):
    """Every spec and control message of the traced cell so far (spawn,
    pings, policy relays, stats replies with trace deltas) holds no
    torch.Tensor — policies and state bins travel as host arrays."""
    cluster, store, box = traced
    store.publish(_policies(live, seed=31))             # a relay
    cluster.warmup()
    deadline = time.monotonic() + 60.0
    while (min(cluster.version_lag()["replica_versions"]) < store.version
           and time.monotonic() < deadline):
        time.sleep(0.02)
    cluster.stats()
    cluster.kernel_launches()
    kinds = {(d, m[0] if d != "spec" else "spec") for d, m in box}
    assert {("spec", "spec"), ("out", "policy"), ("out", "ping"),
            ("out", "stats"), ("out", "warmup"),
            ("in", "pong"), ("in", "stats"), ("in", "applied"),
            ("in", "warmed")} <= kinds
    for d, m in box:
        assert _tensors_in(m) == [], (d, m if d != "spec" else "spec")
    spec = next(m for d, m in box if d == "spec")
    assert isinstance(spec.bins.u_edges, messages.HostTensor)
    assert spec.device == "cpu" and spec.log_path and spec.live


def test_gate_p4_host_codec_round_trips_bit_for_bit(live):
    """Q tables, production plans (bool and int tensors), state bins and
    L1 parameters: ``from_host(to_host(x))`` is x, dtype and bits."""
    store = _store(live, seed=40)
    snap = store.snapshot()
    values = (dict(snap.policies), dict(snap.fallbacks), live.bins,
              live.l1_params, live.baseline_policies())
    for x in values:
        host = to_host(x)
        assert _tensors_in(host) == []
        back = from_host(host, "cpu")

        def pairs(a, b):
            if isinstance(a, torch.Tensor):
                yield a, b
            elif isinstance(a, dict):
                for k in a:
                    yield from pairs(a[k], b[k])
            elif dataclasses.is_dataclass(a):
                assert type(a) is type(b)
                for f in dataclasses.fields(a):
                    yield from pairs(getattr(a, f.name), getattr(b, f.name))

        n = 0
        for a, b in pairs(x, back):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.device.type == b.device.type == "cpu"
            assert a.numpy().tobytes() == b.numpy().tobytes()
            n += 1
        assert n > 0


# -------------------------------------------------- SIGKILL and respawn
def test_worker_sigkill_respawns_and_no_ticket_drops(live, tmp_path):
    """SIGKILL mid-stream: outstanding tickets are requeued to the
    respawned worker (or explicitly shed) — never dropped — the fresh
    worker serves correctly, the salvage leaves a postmortem bundle
    behind (metrics snapshot + trace tail + event-ring tail), and the
    parent's rings of the dead worker are unlinked."""
    import json

    store = _store(live)
    cluster = _process_cell(live, store, tmp_path, n_replicas=1,
                            tracer=Tracer(), max_worker_restarts=2,
                            engine_cfg=EngineConfig(min_bucket=8, max_bucket=8,
                                                    cache_capacity=0))
    with cluster:
        replica = cluster.replicas[0]
        first = cluster.serve(list(range(8)), timeout_s=TIMEOUT_S)
        assert not any(isinstance(r, Shed) for r in first)
        cluster.stats()        # lands the first wave's metrics + trace delta
        pid_before = replica.worker_pid
        rings_before = (replica._req.name, replica._resp.name)
        tickets = [cluster.submit(q) for q in range(8, 24)]
        os.kill(pid_before, signal.SIGKILL)
        results = [t.result(timeout=TIMEOUT_S) for t in tickets]
        assert all(r is not None for r in results), "dropped tickets"
        deadline = time.monotonic() + TIMEOUT_S
        while (len(replica.spawn_seconds) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert replica.n_restarts >= 1
        assert replica.worker_pid != pid_before
        assert len(replica.spawn_seconds) == 2
        for name in rings_before:
            assert not Path("/dev/shm", name.lstrip("/")).exists()
        again = cluster.serve(list(range(8)), timeout_s=TIMEOUT_S)
        assert not any(isinstance(r, Shed) for r in again)
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            stats = cluster.stats()
            if stats["n_submitted"] == stats["n_responses"] + stats["n_shed"]:
                break
            time.sleep(0.01)
        assert stats["n_submitted"] == stats["n_responses"] + stats["n_shed"]
        assert stats["replicas"][0]["n_restarts"] >= 1
        assert replica.last_bundle_path is not None
        bundle = json.loads(Path(replica.last_bundle_path).read_text())
        assert bundle["reason"] == "worker_dead"
        assert bundle["worker_pid"] == pid_before
        assert bundle["death_traceback"] is None   # SIGKILL leaves none
        assert bundle["config"]["backend"] == "process"
        assert any(k.startswith("serve.requests")
                   for k in bundle["metrics"]), "no metrics snapshot"
        assert bundle["trace_tail"], "no trace tail in bundle"
        assert all("wpid" in (e["args"] or {}) for e in bundle["trace_tail"]
                   if str(e["track"]).startswith("ticket #"))
        kinds = [e["kind"] for e in bundle["events_tail"]]
        assert "worker_dead" in kinds
        all_kinds = {e["kind"] for e in cluster.events.tail()}
        assert {"worker_dead", "worker_restart"} <= all_kinds


def test_commit_during_respawn_reaches_the_new_worker(live, tmp_path):
    """A freshness tick (query appends, then a commit) published after a
    respawn's spec was captured and before its worker started still
    reaches that worker: its fresh queries are served at the new epoch,
    and the next tick's log rows follow without a gap (no second
    restart)."""
    import threading

    store = _store(live, seed=40)
    cluster = _process_cell(live, store, tmp_path, n_replicas=1,
                            max_worker_restarts=2,
                            engine_cfg=EngineConfig(min_bucket=8, max_bucket=8,
                                                    cache_capacity=0))
    rng = np.random.default_rng(43)

    def tick():
        docs = [_doc(rng) for _ in range(4)]
        new_ids = live.add_documents(docs, static_rank=[0.01] * 4)
        fresh = live.append_queries([d[2][:3] for d in docs], [CAT1] * 4,
                                    judged_ids=[[i] for i in new_ids],
                                    judged_gains=[[4]] * 4)
        live.commit_index()
        return [int(q) for q in fresh]

    def serve_fresh(qids):
        res = cluster.serve(qids, timeout_s=TIMEOUT_S)
        assert not any(isinstance(r, Shed) for r in res), res
        ids, _sc, u = _direct(live, store.snapshot().policies, qids)
        for r, i, uu in zip(res, ids, u, strict=True):
            np.testing.assert_array_equal(r.doc_ids, i)
            assert r.u == uu and r.index_epoch == live.index_epoch

    with cluster:
        replica = cluster.replicas[0]
        spec_factory = replica.spec_factory
        ticked = {}

        def spec_then_tick(*args):
            # The respawn's spec is captured; a tick commits on another
            # thread (as a freshness workload does) before the worker
            # process starts.
            spec = spec_factory(*args)
            e0 = live.index_epoch
            t = threading.Thread(target=lambda: ticked.update(q=tick()))
            t.start()
            deadline = time.monotonic() + TIMEOUT_S
            while live.index_epoch == e0 and time.monotonic() < deadline:
                time.sleep(0.005)
            ticked["thread"] = t
            return spec

        replica.spec_factory = spec_then_tick
        pid_before = replica.worker_pid
        os.kill(pid_before, signal.SIGKILL)
        deadline = time.monotonic() + TIMEOUT_S
        while (len(replica.spawn_seconds) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert len(replica.spawn_seconds) == 2
        replica.spec_factory = spec_factory
        ticked["thread"].join(TIMEOUT_S)
        _await_acks(cluster, store.version, live.index_epoch)
        serve_fresh(ticked["q"])
        serve_fresh(tick())                       # the next relayed tail
        assert replica.n_restarts == 1 and replica.worker_pid != pid_before


# ------------------------------------------------- gate P2: the follower
def test_gate_p2_follower_matches_reference_at_every_epoch(tmp_path):
    p = dict(LIVE, seed=3, n_queries=64)
    parent = LiveRetrievalSystem(_cfg(SystemConfig, CorpusConfig,
                                      QueryLogConfig, p),
                                 capacity_docs=CAPACITY,
                                 storage_dir=tmp_path / "gens", device="cpu")
    epochs = []
    parent.live.store.subscribe(epochs.append)
    base_dir = tmp_path / "base"
    BaseSegment.from_index(parent.index).save(base_dir)
    save_log(parent, tmp_path / "log.npz")
    rng = np.random.default_rng(21)
    for step in range(3):
        parent.add_documents([_doc(rng) for _ in range(40)],
                             static_rank=[0.01] * 40)
        for d in rng.choice(p["n_docs"], size=6, replace=False):
            parent.update_document(int(d), _doc(rng))
        parent.commit_index()
        if step == 1:
            parent.merge_index()
    assert len(epochs) == 5 and epochs[-1].generation == 1

    def relay(e):
        assert e.view.base.path is not None
        return (e.version, e.generation, str(e.view.base.path), tuple(e.ops))

    log, idf = load_log(tmp_path / "log.npz")
    mine = FollowerSystem(parent.cfg, base_dir, capacity_docs=CAPACITY,
                          init_epoch=relay(epochs[0]), device="cpu",
                          log=log, idf=idf)
    theirs = JFollowerSystem(_cfg(JSystemConfig, JCorpusConfig,
                                  JQueryLogConfig, p),
                             base_dir, capacity_docs=CAPACITY,
                             init_epoch=relay(epochs[0]))
    for k in ("terms", "n_terms", "category", "judged_ids", "judged_gains"):
        np.testing.assert_array_equal(getattr(mine.log, k),
                                      getattr(theirs.log, k))
    np.testing.assert_array_equal(mine.idf_all, theirs.idf_all)
    qids = rng.choice(p["n_queries"], size=12, replace=False)
    for e in epochs:
        v, g, d, ops = relay(e)
        jops = [JDeltaOp(o.kind, o.doc_id, o.fields, o.static_rank)
                for o in ops]
        assert mine.apply_epoch(v, g, d, ops) == e.version
        assert theirs.apply_epoch(v, g, d, jops) == e.version
        assert mine.apply_epoch(v, g, d, ops) == e.version      # duplicate
        mine_e = mine.index_epoch_store.snapshot()
        assert (mine_e.version, mine_e.generation) == (e.version,
                                                       e.generation)
        occ, scores, tp = mine.batch_inputs(qids)
        j_occ = np.asarray(theirs.batch_inputs(qids)[0])
        p_occ, p_scores, p_tp = parent.batch_inputs(qids, epoch=e)
        np.testing.assert_array_equal(occ.numpy().view(np.uint32),
                                      j_occ.view(np.uint32))
        assert torch.equal(occ, p_occ) and torch.equal(tp, p_tp)
        assert torch.equal(scores, p_scores)
        assert check_epoch_parity(mine, mine_e, qids)["ok"]
        cats = mine.log.category[qids]
        for backend in ("reference", "block_scan"):
            for cat in np.unique(cats):
                rows = torch.from_numpy(np.where(cats == cat)[0])
                plan = mine.plan_for_category(int(cat))
                a, _ = plan_rollout(mine.env_cfg, mine.ruleset, plan,
                                    occ[rows], scores[rows], tp[rows],
                                    backend=backend)
                b, _ = plan_rollout(parent.env_cfg, parent.ruleset, plan,
                                    p_occ[rows], p_scores[rows], p_tp[rows],
                                    backend=backend)
                for k in ("u", "v", "cand", "cand_cnt", "topn"):
                    assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert len(mine._bases) <= 2


def test_follower_extends_its_log_from_relayed_rows(live, tmp_path):
    """The rows a live system appends travel as a log tail: a follower
    whose log holds some of them appends the rest, and its log and IDF
    rows then equal the parent's; a gap is refused."""
    from repro_torch.cluster.proc.follower import LOG_FIELDS, log_tail

    base_dir = tmp_path / "base"
    BaseSegment.from_index(live.index).save(base_dir)
    n0 = live.log.n_queries
    rng = np.random.default_rng(41)
    live.append_queries([_doc(rng)[2][:2] for _ in range(3)], [CAT1] * 3)
    e = live.index_epoch_store.snapshot()
    gen = tmp_path / "gen"
    e.view.base.save(gen)
    save_log(live, tmp_path / "log.npz")
    log, idf = load_log(tmp_path / "log.npz")
    for k in LOG_FIELDS:                              # back to the seed log
        setattr(log, k, getattr(log, k)[:LIVE["n_queries"]])
    fol = FollowerSystem(live.cfg, base_dir, capacity_docs=CAPACITY,
                         init_epoch=(e.version, e.generation, str(gen),
                                     tuple(e.ops)),
                         log=log, idf=idf[:LIVE["n_queries"]], device="cpu")
    assert fol.log.n_queries == LIVE["n_queries"]
    q0, rows = log_tail(live, LIVE["n_queries"])
    part = {k: v[: n0 + 1 - q0] for k, v in rows.items() if k != "popularity"}
    part["popularity"] = rows["popularity"][: n0 + 1]
    assert fol.extend_log(q0, part) == n0 + 1
    q1, rows = log_tail(live, n0 - 2)             # overlaps what it holds
    assert fol.extend_log(q1, rows) == n0 + 3
    assert fol.extend_log(q1, rows) == n0 + 3     # a duplicate: no-op
    for k in LOG_FIELDS + ("popularity",):
        np.testing.assert_array_equal(getattr(fol.log, k),
                                      getattr(live.log, k))
    np.testing.assert_array_equal(fol.idf_all, live.idf_all)
    assert log_tail(live, live.log.n_queries) is None
    with pytest.raises(ValueError, match="past"):
        fol.extend_log(n0 + 5, rows)


# ------------------------------------------------------------ CLI, loader
def test_cluster_cli_process_smoke_on_cpu(tmp_path):
    """``launch/cluster.py --smoke --replica-backend process`` on the
    CPU: a live system through 2 worker processes, 3 policy versions and
    2 committed epochs relayed, the single-mapping proof, the merged
    trace through ``tools/check_trace.py --require-proc-chain``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    trace = tmp_path / "t.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--smoke",
         "--replica-backend", "process", "--device", "cpu", "--out",
         str(tmp_path / "c.json"), "--trace-out", str(trace),
         "--metrics-json", str(tmp_path / "m.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "[smoke] proc cell OK" in res.stdout
    import json
    out = json.loads((tmp_path / "c.json").read_text())
    assert out["proc"]["worker_devices"] == ["cpu", "cpu"]
    assert min(out["proc"]["replica_index_epochs"]) >= 3
    chk = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_trace.py"), str(trace),
         "--require-proc-chain", "--metrics", str(tmp_path / "m.json")],
        capture_output=True, text=True, timeout=120)
    assert chk.returncode == 0, chk.stdout + chk.stderr


_BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from repro_torch.kernels import native
    native.CSRC_DIR = Path(sys.argv[1])
    native.BUILD_ROOT = Path(sys.argv[2])
    native._nvcc = lambda: sys.argv[3]
    import ctypes
    k = native.NativeKernel("probe", "probe.cu", (), "probe_entry",
                            [ctypes.c_int])
    k.launch(0)
    print("launched", k.launches)
""")

_FAKE_NVCC = textwrap.dedent("""
    import subprocess, sys, time
    a = sys.argv[1:]
    out, src = a[a.index("-o") + 1], a[-1]
    open(out, "wb").write(b"partial")     # a half-written library
    time.sleep(1.0)                       # both builds overlap here
    subprocess.run(["g++", "-shared", "-fPIC", "-x", "c++", "-o", out, src],
                   check=True)
""")


def test_native_build_two_processes_into_one_build_dir(tmp_path):
    """Two processes whose first launch is also the library's first
    build run the compiler at once into one build dir: each writes a
    temporary file of its own name, and the library loads in both."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "probe.cu").write_text(
        'extern "C" int probe_entry(int x) { return x; }\n')
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + _FAKE_NVCC)
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(csrc),
                               str(build), str(nvcc)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "launched 1"
    libs = list(build.rglob("libprobe.so"))
    assert len(libs) == 1
    assert not list(build.rglob("*.tmp"))
