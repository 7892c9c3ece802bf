"""Fixed-slot SPSC ring buffers over POSIX shared memory.

The port's copy of the reference's ``cluster/proc/ring.py``: header,
slot and sequence-number layout are the reference's byte for byte, so a
ring created by either package is attached and drained by the other.

The router→replica hop in the process cell is a **memcpy, not a
pickle**: requests and responses are fixed-layout binary records (see
`repro_torch.cluster.proc.messages`) pushed through one single-producer /
single-consumer ring per direction per replica.  The ring lives in a
`multiprocessing.shared_memory` segment sized at creation — slot count
and slot payload capacity are fixed, so both sides compute every
offset arithmetically and never allocate.

Protocol — bounded MPMC queue à la Vyukov, specialised to SPSC:

- each slot starts with a u64 sequence number, initialised to its own
  slot index ``j``;
- the producer claims position ``pos`` (its private monotonically
  increasing counter mirrored at header ``tail``), waits until
  ``slot[pos % n].seq == pos``, memcpys the payload, then publishes by
  setting ``seq = pos + 1``;
- the consumer at position ``pos`` (header ``head``) waits until
  ``seq == pos + 1``, copies the payload out, then recycles the slot
  with ``seq = pos + n``.

The sequence word is the only synchronisation point: it is written
last by the producer and last by the consumer, so a torn read can
never expose a half-written payload (CPython's GIL + the kernel give
us cache coherence; numpy u64 loads/stores on aligned memory are
single instructions).  ``head``/``tail`` in the header are advisory
mirrors used for occupancy/telemetry — correctness never reads them.

Waiting is hybrid: spin for a few hundred iterations (the common case
under load — the peer is actively draining), then sleep with capped
exponential backoff ("park").  Parks and wakes are counted in the
header so the obs plane can report contention per replica.

Header layout (64 bytes, one cache line):

====== ======= ====================================================
offset  type    field
====== ======= ====================================================
0       u64     head       consumer position (advisory mirror)
8       u64     tail       producer position (advisory mirror)
16      u64     producer_parks   producer slept waiting for space
24      u64     consumer_parks   consumer slept waiting for data
32      u64     wakes      successful pops after at least one park
40      f64     heartbeat  writer-stamped monotonic time (liveness)
48      u64     depth_hint writer-published queue depth (router load)
56      u64     (reserved)
====== ======= ====================================================
"""
from __future__ import annotations

import struct
import time
from multiprocessing import shared_memory
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["RingClosed", "RingFull", "ShmRing"]

_HDR_BYTES = 64
_OFF_HEAD = 0
_OFF_TAIL = 8
_OFF_PROD_PARKS = 16
_OFF_CONS_PARKS = 24
_OFF_WAKES = 32
_OFF_HEARTBEAT = 40
_OFF_DEPTH_HINT = 48

_SLOT_HDR = struct.Struct("<QII")   # seq u64, len u32, pad u32
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")

_SPIN_ITERS = 200          # busy iterations before the first sleep
_PARK_MIN_S = 50e-6        # first sleep
_PARK_MAX_S = 2e-3         # backoff cap


class RingFull(Exception):
    """try_push on a full ring."""


class RingClosed(Exception):
    """The peer died or the ring was closed while waiting."""


def _align8(n: int) -> int:
    return (n + 7) & ~7


class ShmRing:
    """One direction of a replica's message channel.

    Exactly one producer and one consumer, in different processes.
    Create with :meth:`create` (owner side, unlinks on close) and
    :meth:`attach` (peer side, never unlinks).
    """

    def __init__(self, shm: shared_memory.SharedMemory, n_slots: int,
                 slot_bytes: int, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes            # payload capacity
        self._slot_stride = _align8(_SLOT_HDR.size + slot_bytes)
        self._owner = owner
        self._closed = False
        # Private positions — the shared head/tail words are advisory.
        self._head = 0
        self._tail = 0
        # Lazy numpy views for the batch paths (see _views): strided
        # windows over the SAME shared buffer the scalar path uses.
        self._np_seq = None
        self._np_len = None
        self._np_payload = None

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, n_slots: int, slot_bytes: int,
               name: Optional[str] = None) -> "ShmRing":
        if n_slots < 2 or n_slots & (n_slots - 1):
            raise ValueError(f"n_slots must be a power of two >= 2, "
                             f"got {n_slots}")
        stride = _align8(_SLOT_HDR.size + slot_bytes)
        size = _HDR_BYTES + n_slots * stride
        shm = shared_memory.SharedMemory(create=True, size=size, name=name)
        ring = cls(shm, n_slots, slot_bytes, owner=True)
        shm.buf[:_HDR_BYTES] = b"\x00" * _HDR_BYTES
        for j in range(n_slots):
            off = ring._slot_off(j)
            _SLOT_HDR.pack_into(shm.buf, off, j, 0, 0)
        return ring

    @classmethod
    def attach(cls, name: str, n_slots: int, slot_bytes: int) -> "ShmRing":
        shm = shared_memory.SharedMemory(name=name)
        # CPython registers every attach with the resource_tracker
        # (bpo-38119).  Workers are spawned by the ring's creator, so
        # they SHARE its tracker process and the double registration is
        # an idempotent set-add — the creator's unlink() performs the
        # single matching unregister.  (Do NOT unregister here: that
        # would remove the creator's entry and make its later unlink
        # KeyError inside the shared tracker.)
        return cls(shm, n_slots, slot_bytes, owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Drop the numpy views BEFORE the memoryview: each one holds a
        # buffer export of the shm mapping, and SharedMemory.close()
        # raises BufferError while any export is alive.
        self._np_seq = self._np_len = self._np_payload = None
        self._buf = None
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    # -------------------------------------------------------------- header
    def _load_u64(self, off: int) -> int:
        return _U64.unpack_from(self._buf, off)[0]

    def _store_u64(self, off: int, val: int) -> None:
        _U64.pack_into(self._buf, off, val)

    def _bump_u64(self, off: int) -> None:
        # Single writer per counter → plain read-modify-write is safe.
        _U64.pack_into(self._buf, off,
                       _U64.unpack_from(self._buf, off)[0] + 1)

    def stamp_heartbeat(self) -> None:
        _F64.pack_into(self._buf, _OFF_HEARTBEAT, time.monotonic())

    def heartbeat(self) -> float:
        return _F64.unpack_from(self._buf, _OFF_HEARTBEAT)[0]

    def set_depth_hint(self, depth: int) -> None:
        self._store_u64(_OFF_DEPTH_HINT, max(0, depth))

    def depth_hint(self) -> int:
        return self._load_u64(_OFF_DEPTH_HINT)

    def occupancy(self) -> int:
        """Messages currently in the ring (advisory — reads the
        mirrored head/tail, fine for load signals and stats)."""
        return max(0, self._load_u64(_OFF_TAIL) - self._load_u64(_OFF_HEAD))

    def park_stats(self) -> dict:
        return {"producer_parks": self._load_u64(_OFF_PROD_PARKS),
                "consumer_parks": self._load_u64(_OFF_CONS_PARKS),
                "wakes": self._load_u64(_OFF_WAKES)}

    # --------------------------------------------------------------- slots
    def _slot_off(self, j: int) -> int:
        return _HDR_BYTES + j * self._slot_stride

    def _slot_seq(self, j: int) -> int:
        return _U64.unpack_from(self._buf, self._slot_off(j))[0]

    # ------------------------------------------------------------ producer
    def try_push(self, payload: bytes) -> bool:
        """Push without blocking; False when the ring is full."""
        if self._closed:
            raise RingClosed("ring closed")
        if len(payload) > self.slot_bytes:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds slot capacity "
                f"{self.slot_bytes}; oversized messages must be rejected "
                "at the codec layer, not silently truncated")
        pos = self._tail
        j = pos & (self.n_slots - 1)
        off = self._slot_off(j)
        if self._slot_seq(j) != pos:
            return False                        # slot not yet recycled
        body = off + _SLOT_HDR.size
        self._buf[body: body + len(payload)] = payload
        _U32.pack_into(self._buf, off + 8, len(payload))
        # Publish seq LAST, as its own store: a combined header write
        # can become visible low-address-first, letting the consumer
        # see the new seq with a stale length (torn read).
        _U64.pack_into(self._buf, off, pos + 1)
        self._tail = pos + 1
        self._store_u64(_OFF_TAIL, self._tail)
        return True

    def push(self, payload: bytes,
             deadline_s: Optional[float] = None,
             alive: Optional[callable] = None) -> None:
        """Blocking push with spin-then-park wait.

        ``alive`` is polled while parked; when it returns False the
        peer is considered dead and :class:`RingClosed` is raised —
        the caller requeues, it must not spin on a corpse.
        """
        spins = 0
        sleep_s = _PARK_MIN_S
        parked = False
        while not self.try_push(payload):
            spins += 1
            if spins < _SPIN_ITERS:
                continue
            if not parked:
                parked = True
                self._bump_u64(_OFF_PROD_PARKS)
            if alive is not None and not alive():
                raise RingClosed("consumer gone")
            if deadline_s is not None and time.monotonic() > deadline_s:
                raise RingClosed("push deadline exceeded")
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 2, _PARK_MAX_S)

    # ------------------------------------------------------------ consumer
    def try_pop(self) -> Optional[bytes]:
        if self._closed:
            raise RingClosed("ring closed")
        pos = self._head
        j = pos & (self.n_slots - 1)
        off = self._slot_off(j)
        if self._slot_seq(j) != pos + 1:
            return None                         # nothing published yet
        # seq was published after len + payload, so both are valid here
        length = _U32.unpack_from(self._buf, off + 8)[0]
        body = off + _SLOT_HDR.size
        payload = bytes(self._buf[body: body + length])
        # Recycle by storing ONLY seq — the producer rewrites len
        _U64.pack_into(self._buf, off, pos + self.n_slots)
        self._head = pos + 1
        self._store_u64(_OFF_HEAD, self._head)
        return payload

    def pop_many(self, limit: int = 64) -> Iterator[bytes]:
        """Drain up to ``limit`` available messages without blocking."""
        for _ in range(limit):
            msg = self.try_pop()
            if msg is None:
                return
            yield msg

    def pop(self, timeout_s: Optional[float] = None,
            alive: Optional[callable] = None) -> Optional[bytes]:
        """Blocking pop with spin-then-park wait; None on timeout."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        spins = 0
        sleep_s = _PARK_MIN_S
        parked = False
        while True:
            msg = self.try_pop()
            if msg is not None:
                if parked:
                    self._bump_u64(_OFF_WAKES)
                return msg
            spins += 1
            if spins < _SPIN_ITERS:
                continue
            if not parked:
                parked = True
                self._bump_u64(_OFF_CONS_PARKS)
            if alive is not None and not alive():
                raise RingClosed("producer gone")
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 2, _PARK_MAX_S)

    # ------------------------------------------------------- batch transfer
    # The batch paths move B records per ring operation: ONE bulk copy
    # into the payload region, ONE gate publish (slot ``pos``'s sequence
    # word, stored last — the consumer pops strictly in order, so slots
    # pos+1..pos+k-1 published before it stay invisible until the gate
    # opens), and one park/wake per batch episode instead of per record.
    # A batch never spans the wraparound: each call covers one
    # contiguous slot run and the caller loops — a split batch lands as
    # two (whole) publishes, records are never torn.

    def _views(self):
        """Strided numpy windows over the slot region (lazy; shared
        with the scalar path byte-for-byte).  seq/len are per-slot
        columns; payload is the (n_slots, slot_bytes) data matrix."""
        if self._np_seq is None:
            if self._closed:
                raise RingClosed("ring closed")
            n, stride = self.n_slots, self._slot_stride
            raw = np.frombuffer(self._buf, np.uint8,
                                count=_HDR_BYTES + n * stride)
            slots = raw[_HDR_BYTES:].reshape(n, stride)
            self._np_seq = slots[:, :8].view("<u8")[:, 0]
            self._np_len = slots[:, 8:12].view("<u4")[:, 0]
            self._np_payload = slots[:, _SLOT_HDR.size:
                                     _SLOT_HDR.size + self.slot_bytes]
        return self._np_seq, self._np_len, self._np_payload

    def _free_run(self, seq, want: int):
        """(pos, j0, k): producer-side length of the free contiguous
        slot run starting at the tail, capped at ``want`` and the lap
        boundary."""
        pos = self._tail
        j0 = pos & (self.n_slots - 1)
        run = min(want, self.n_slots - j0)
        free = seq[j0:j0 + run] == (
            pos + np.arange(run, dtype=np.uint64))
        k = int(run if free.all() else np.argmin(free))
        return pos, j0, k

    def _publish(self, seq, pos: int, j0: int, k: int) -> None:
        if k > 1:
            seq[j0 + 1:j0 + k] = pos + 1 + np.arange(1, k, dtype=np.uint64)
        seq[j0] = pos + 1                       # the gate
        self._tail = pos + k
        self._store_u64(_OFF_TAIL, self._tail)

    def try_push_records(self, recs) -> int:
        """Publish a FIFO prefix of ``recs`` — an (m, rec_bytes) uint8
        matrix of fixed-size records — in one bulk copy + one gate
        store.  Returns how many were pushed (0 when full); never
        writes a partial record."""
        if self._closed:
            raise RingClosed("ring closed")
        recs = np.ascontiguousarray(recs, np.uint8)
        if recs.ndim != 2:
            raise ValueError(
                f"records must be an (m, rec_bytes) matrix, "
                f"got shape {recs.shape}")
        m, rec_bytes = recs.shape
        if rec_bytes > self.slot_bytes:
            raise ValueError(
                f"record of {rec_bytes} bytes exceeds slot capacity "
                f"{self.slot_bytes}; oversized messages must be rejected "
                "at the codec layer, not silently truncated")
        if m == 0:
            return 0
        seq, lenv, payload = self._views()
        pos, j0, k = self._free_run(seq, m)
        if k == 0:
            return 0
        payload[j0:j0 + k, :rec_bytes] = recs[:k]
        lenv[j0:j0 + k] = rec_bytes
        self._publish(seq, pos, j0, k)
        return k

    def try_push_many(self, payloads: List[bytes]) -> int:
        """Variable-length sibling of :meth:`try_push_records`: pushes
        a FIFO prefix of ``payloads`` with one gate store.  EVERY
        payload is length-validated before ANY slot is written, so an
        oversized record inside a batch raises without corrupting the
        sequence protocol or publishing a partial batch."""
        if self._closed:
            raise RingClosed("ring closed")
        for p in payloads:
            if len(p) > self.slot_bytes:
                raise ValueError(
                    f"payload of {len(p)} bytes exceeds slot capacity "
                    f"{self.slot_bytes}; oversized messages must be "
                    "rejected at the codec layer, not silently truncated")
        if not payloads:
            return 0
        seq, lenv, payload = self._views()
        pos, j0, k = self._free_run(seq, len(payloads))
        if k == 0:
            return 0
        for i in range(k):
            p = payloads[i]
            payload[j0 + i, :len(p)] = np.frombuffer(p, np.uint8)
            lenv[j0 + i] = len(p)
        self._publish(seq, pos, j0, k)
        return k

    def _push_all(self, pusher, total: int,
                  deadline_s: Optional[float] = None,
                  alive: Optional[callable] = None) -> None:
        """Drive a try_push_* callable until ``total`` records landed,
        with the spin-then-park wait counted ONCE per batch episode."""
        done = 0
        spins = 0
        sleep_s = _PARK_MIN_S
        parked = False
        while done < total:
            k = pusher(done)
            if k:
                done += k
                spins = 0
                continue
            spins += 1
            if spins < _SPIN_ITERS:
                continue
            if not parked:
                parked = True
                self._bump_u64(_OFF_PROD_PARKS)
            if alive is not None and not alive():
                raise RingClosed("consumer gone")
            if deadline_s is not None and time.monotonic() > deadline_s:
                raise RingClosed("push deadline exceeded")
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 2, _PARK_MAX_S)

    def push_records(self, recs,
                     deadline_s: Optional[float] = None,
                     alive: Optional[callable] = None) -> None:
        """Blocking fixed-size batch push.  A batch larger than the
        free slot run lands as several whole sub-batches (split at the
        wraparound / occupancy boundary, records never torn)."""
        recs = np.ascontiguousarray(recs, np.uint8)
        self._push_all(lambda done: self.try_push_records(recs[done:]),
                       recs.shape[0], deadline_s=deadline_s, alive=alive)

    def push_many(self, payloads: List[bytes],
                  deadline_s: Optional[float] = None,
                  alive: Optional[callable] = None) -> None:
        """Blocking variable-length batch push (validates every length
        up front; see :meth:`try_push_many`)."""
        for p in payloads:
            if len(p) > self.slot_bytes:
                raise ValueError(
                    f"payload of {len(p)} bytes exceeds slot capacity "
                    f"{self.slot_bytes}; oversized messages must be "
                    "rejected at the codec layer, not silently truncated")
        self._push_all(lambda done: self.try_push_many(payloads[done:]),
                       len(payloads), deadline_s=deadline_s, alive=alive)

    def _ready_run(self, seq, want: int):
        """(pos, j0, r): consumer-side length of the published run
        starting at the head, capped at ``want`` and the lap
        boundary."""
        pos = self._head
        j0 = pos & (self.n_slots - 1)
        run = min(want, self.n_slots - j0)
        if run <= 0:
            return pos, j0, 0
        ready = seq[j0:j0 + run] == (
            pos + 1 + np.arange(run, dtype=np.uint64))
        r = int(run if ready.all() else np.argmin(ready))
        return pos, j0, r

    def _recycle(self, seq, pos: int, j0: int, r: int) -> None:
        # Mirror of _publish: later slots recycle first, slot ``pos``'s
        # store is the gate — the producer claims slots strictly in
        # order, so no slot frees up before the whole batch is copied.
        n = self.n_slots
        if r > 1:
            seq[j0 + 1:j0 + r] = pos + n + np.arange(1, r, dtype=np.uint64)
        seq[j0] = pos + n
        self._head = pos + r
        self._store_u64(_OFF_HEAD, self._head)

    def try_pop_records(self, limit: int, rec_bytes: int) -> np.ndarray:
        """Pop up to ``limit`` fixed-size records in one gather; returns
        an owned (r, rec_bytes) uint8 matrix (possibly empty)."""
        if self._closed:
            raise RingClosed("ring closed")
        seq, lenv, payload = self._views()
        pos, j0, r = self._ready_run(seq, int(limit))
        if r == 0:
            return np.empty((0, rec_bytes), np.uint8)
        if not (lenv[j0:j0 + r] == rec_bytes).all():
            raise ValueError(
                f"fixed-size pop of {rec_bytes}-byte records found other "
                f"lengths {sorted(set(int(x) for x in lenv[j0:j0 + r]))} — "
                "producer/consumer codec mismatch")
        out = payload[j0:j0 + r, :rec_bytes].copy()
        self._recycle(seq, pos, j0, r)
        return out

    def try_pop_batch(self, limit: int = 64) -> List[bytes]:
        """Variable-length batch pop: up to ``limit`` payloads with one
        batched recycle (one gate store, not one per message)."""
        if self._closed:
            raise RingClosed("ring closed")
        seq, lenv, payload = self._views()
        pos, j0, r = self._ready_run(seq, int(limit))
        if r == 0:
            return []
        out = [bytes(payload[j0 + i, :int(lenv[j0 + i])]) for i in range(r)]
        self._recycle(seq, pos, j0, r)
        return out

    def pop_batch(self, limit: int = 64,
                  timeout_s: Optional[float] = None,
                  alive: Optional[callable] = None) -> List[bytes]:
        """Blocking variable-length batch pop; empty list on timeout.
        Parks once per empty episode and counts one wake per batch."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        spins = 0
        sleep_s = _PARK_MIN_S
        parked = False
        while True:
            out = self.try_pop_batch(limit)
            if out:
                if parked:
                    self._bump_u64(_OFF_WAKES)
                return out
            spins += 1
            if spins < _SPIN_ITERS:
                continue
            if not parked:
                parked = True
                self._bump_u64(_OFF_CONS_PARKS)
            if alive is not None and not alive():
                raise RingClosed("producer gone")
            if deadline is not None and time.monotonic() > deadline:
                return []
            time.sleep(sleep_s)
            sleep_s = min(sleep_s * 2, _PARK_MAX_S)
