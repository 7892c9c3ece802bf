"""Process-backed serving cell: GIL-free replicas over one mmap-shared
index (the port's copy of the reference's ``cluster/proc``).

`ReplicaSet(..., ClusterConfig(backend="process"))` swaps each
thread-backed `Replica` for a :class:`ProcessReplica` — a worker
process that mmaps the cell's saved base generation (one page-cache
copy fleet-wide), receives tickets over a binary shared-memory ring
(`ShmRing`), and follows policy/index publishes relayed over its
control pipe (`FollowerSystem`).  Each worker builds its system on the
parent system's device and launches its own kernels there: on one
card, every worker holds its own CUDA context.
"""
from .follower import FollowerSystem
from .messages import (REQUEST_BYTES, decode_request, decode_response,
                       encode_request, encode_response, from_host,
                       response_bytes, to_host)
from .replica import ProcessReplica
from .ring import RingClosed, RingFull, ShmRing
from .worker import WorkerSpec, worker_main

__all__ = ["FollowerSystem", "ProcessReplica", "REQUEST_BYTES",
           "RingClosed", "RingFull", "ShmRing", "WorkerSpec",
           "decode_request", "decode_response", "encode_request",
           "encode_response", "from_host", "response_bytes", "to_host",
           "worker_main"]
