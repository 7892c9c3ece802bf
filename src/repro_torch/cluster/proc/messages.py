"""Fixed-layout binary codecs for the process cell's data plane, and
the host codec of its control plane.

The port's copy of the reference's ``cluster/proc/messages.py``: the
request and response records are the reference's byte for byte.
Requests and responses cross the router↔worker boundary through
`ShmRing` slots as packed structs — no pickle on the hot path.  Slot
capacity is fixed at ring creation, so the response codec is sized for
the engine's ``keep`` (top-k width) and anything larger is rejected at
encode time (the ring raises before a partial write can happen).

Control-plane traffic (policy snapshots, index epochs, worker stats)
is low-rate and structurally rich; it travels pickled over the
worker's `multiprocessing.Pipe` instead — see
`repro_torch.cluster.proc.worker` for the message grammar.  ``import
torch`` registers torch's reducers on multiprocessing's
``ForkingPickler``, which that pipe (and the spawn of a worker) pickles
with: a CPU tensor would be moved into shared memory on the sender's
side, and a CUDA tensor would travel as an IPC handle the sender must
keep alive.  So nothing that crosses it holds a tensor: :func:`to_host`
turns every tensor inside a control payload (policies, fallbacks, L1
parameters, state bins) into a host array on the way out, and
:func:`from_host` turns them back into tensors on the receiver's device.
"""
from __future__ import annotations

import copy
import dataclasses
import struct
from types import MappingProxyType
from typing import Any, Tuple, Union

import numpy as np
import torch

from repro_torch.cluster.admission import Shed
from repro_torch.serving import ServiceLevel
from repro_torch.serving.engine import ServeResponse

__all__ = ["REQUEST_BYTES", "REQ_DTYPE", "HostTensor", "decode_request",
           "decode_request_block", "decode_response", "encode_request",
           "encode_request_block", "encode_response", "from_host",
           "response_bytes", "to_host"]

# ticket u64 | qid i64 | level i32 | category i32 | trace_root u64
# trace_root is the ticket's root span id (0 = tracing off): the trace
# context that rides the data plane so worker-side spans can join the
# parent's per-ticket Perfetto track.
_REQ = struct.Struct("<QqiiQ")
REQUEST_BYTES = _REQ.size

# The same record as a packed numpy dtype: a request SLAB is one
# (n, REQUEST_BYTES) uint8 matrix built/read in a single view, so the
# batch ring paths (`ShmRing.push_records`/`try_pop_records`) move B
# tickets per memcpy.  Field-for-field identical to _REQ — pinned by an
# assert here and a codec-parity test.
REQ_DTYPE = np.dtype([("ticket", "<u8"), ("qid", "<i8"),
                      ("level", "<i4"), ("category", "<i4"),
                      ("trace_root", "<u8")])
assert REQ_DTYPE.itemsize == REQUEST_BYTES

# ticket u64 | qid i64 | category i32 | level i32 | status u8 | cached u8
# | pad u16 | u i32 | cand_cnt i32 | policy_version i32 | index_epoch i32
# | n_docs i32 | latency f64 | reason char[48]
_RESP_HDR = struct.Struct("<QqiiBBHiiiiid48s")
_REASON_BYTES = 48

_STATUS_OK = 0
_STATUS_SHED = 1

Result = Union[ServeResponse, Shed]


def response_bytes(keep: int) -> int:
    """Slot payload size for responses carrying up to ``keep`` docs."""
    return _RESP_HDR.size + keep * 8          # keep × (i32 id + f32 score)


# ------------------------------------------------------------- requests
def encode_request(ticket_id: int, qid: int, level: ServiceLevel,
                   category: int, trace_root: int = 0) -> bytes:
    return _REQ.pack(ticket_id, qid, int(level), category, trace_root)


def decode_request(payload: bytes) -> Tuple[int, int, ServiceLevel, int, int]:
    ticket_id, qid, level, category, trace_root = _REQ.unpack(payload)
    return ticket_id, qid, ServiceLevel(level), category, trace_root


def encode_request_block(tickets, qids, levels, categories,
                         trace_roots=None) -> np.ndarray:
    """Pack a whole request slab into one (n, REQUEST_BYTES) uint8
    matrix — five column stores instead of n struct packs."""
    n = len(tickets)
    block = np.empty(n, REQ_DTYPE)
    block["ticket"] = np.asarray(tickets, np.uint64)
    block["qid"] = np.asarray(qids, np.int64)
    block["level"] = np.asarray(levels, np.int32)
    block["category"] = np.asarray(categories, np.int32)
    block["trace_root"] = (0 if trace_roots is None
                           else np.asarray(trace_roots, np.uint64))
    return block.view(np.uint8).reshape(n, REQUEST_BYTES)


def decode_request_block(recs: np.ndarray) -> np.ndarray:
    """Inverse of :meth:`encode_request_block`: an (r, REQUEST_BYTES)
    uint8 matrix (e.g. from ``ShmRing.try_pop_records``) viewed as a
    structured array — fields are columns, no per-record unpack."""
    recs = np.ascontiguousarray(recs, np.uint8)
    return recs.reshape(-1).view(REQ_DTYPE)


# ------------------------------------------------------------ responses
def encode_response(ticket_id: int, result: Result, keep: int) -> bytes:
    if isinstance(result, Shed):
        reason = result.reason.encode("utf-8")[:_REASON_BYTES]
        return _RESP_HDR.pack(
            ticket_id, result.qid, result.category, 0, _STATUS_SHED,
            0, 0, 0, 0, 0, 0, 0, float(result.est_u), reason)
    r = result
    ids = np.asarray(r.doc_ids, dtype=np.int32)
    scores = np.asarray(r.scores, dtype=np.float32)
    n = ids.shape[0]
    if n > keep:
        raise ValueError(f"response carries {n} docs but the ring was "
                         f"sized for keep={keep}")
    hdr = _RESP_HDR.pack(
        ticket_id, r.qid, r.category, int(r.level), _STATUS_OK,
        1 if r.cached else 0, 0, int(r.u), int(r.cand_cnt),
        int(r.policy_version), int(r.index_epoch), n,
        float(r.latency_s), b"")
    return hdr + ids.tobytes() + scores.tobytes()


def decode_response(payload: bytes) -> Tuple[int, Result]:
    (ticket_id, qid, category, level, status, cached, _pad, u, cand_cnt,
     policy_version, index_epoch, n, lat_or_est_u,
     reason) = _RESP_HDR.unpack_from(payload)
    if status == _STATUS_SHED:
        return ticket_id, Shed(qid, category, lat_or_est_u,
                               reason.rstrip(b"\x00").decode("utf-8"))
    off = _RESP_HDR.size
    ids = np.frombuffer(payload, np.int32, count=n, offset=off).copy()
    scores = np.frombuffer(payload, np.float32, count=n,
                           offset=off + 4 * n).copy()
    return ticket_id, ServeResponse(
        request_id=ticket_id, qid=qid, category=category,
        doc_ids=ids, scores=scores, u=u, cand_cnt=cand_cnt,
        cached=bool(cached), latency_s=lat_or_est_u,
        policy_version=policy_version, index_epoch=index_epoch,
        level=ServiceLevel(level))


# --------------------------------------------------------- control plane
@dataclasses.dataclass(frozen=True)
class HostTensor:
    """A tensor's values as a host array, in a control payload."""
    array: np.ndarray


def to_host(obj: Any) -> Any:
    """``obj`` with every ``torch.Tensor`` inside it replaced by a
    :class:`HostTensor` (a copy of its values): through dicts (mapping
    proxies become dicts), lists, tuples, named tuples and dataclasses
    (a shallow copy with each field converted; frozen ones too).
    Anything else is returned as it is."""
    if isinstance(obj, torch.Tensor):
        return HostTensor(obj.detach().cpu().numpy().copy())
    if isinstance(obj, (dict, MappingProxyType)):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):    # namedtuple
        return type(obj)(*(to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name, to_host(getattr(obj, f.name)))
        return out
    return obj


def from_host(obj: Any, device) -> Any:
    """Inverse of :func:`to_host`: every :class:`HostTensor` becomes a
    tensor on ``device``, bit for bit."""
    if isinstance(obj, HostTensor):
        return torch.from_numpy(np.array(obj.array)).to(device)
    if isinstance(obj, dict):
        return {k: from_host(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):    # namedtuple
        return type(obj)(*(from_host(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_host(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name,
                               from_host(getattr(obj, f.name), device))
        return out
    return obj
