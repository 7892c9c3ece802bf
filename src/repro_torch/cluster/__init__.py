"""Online learning cluster (the port of ``repro.cluster``).

A background `TrainerLoop` publishes versioned policy snapshots (live
policies + their SHALLOW fallbacks, atomically) into a shared
`PolicyStore` while a `ReplicaSet` of N `ServeEngine` replicas on
threads serves continuously — queue-aware/cache-affinity routing in
front, a pressure-tiered admission ladder (FULL → SHALLOW → CACHED_ONLY
→ explicit `Shed`) priced in u at the door, per-response policy-version
lag accounting throughout, and a `ServedTrafficTap` feeding the trainer
the queries the fleet actually served.  With
``ClusterConfig(backend="process")`` the replicas are worker processes
over shared-memory rings and one mapped index (`repro_torch.cluster.proc`:
`FollowerSystem`, `ProcessReplica`, `ShmRing`).
"""
from repro_torch.serving.levels import ServiceLevel

from .admission import Admission, AdmissionController, Shed, UCostEstimator
from .cluster import ClusterConfig, ReplicaSet
from .replica import ClusterTicket, Replica
from .router import (QueueAwareRouter, RoundRobinRouter, Router, make_router,
                     stable_query_hash)
from .tap import ServedTrafficTap
from .trainer import TrainerConfig, TrainerLoop, candidate_recall, probe_recall

__all__ = [
    "Admission", "AdmissionController", "ClusterConfig", "ClusterTicket",
    "QueueAwareRouter", "Replica", "ReplicaSet", "RoundRobinRouter",
    "Router", "ServedTrafficTap", "ServiceLevel", "Shed", "TrainerConfig",
    "TrainerLoop", "UCostEstimator", "candidate_recall", "make_router",
    "probe_recall", "stable_query_hash",
]
