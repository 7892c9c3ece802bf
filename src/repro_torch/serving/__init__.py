"""Online query-serving engine (the port of ``repro.serving``).

submit → admission → result cache → shape-bucketed micro-batch →
prepared per-(bucket, policy-structure, level) serve step → scatter–
gather merge → L1 prune → respond, with per-request latency/u
telemetry.  Policies come from a versioned
`repro_torch.policies.PolicyStore` snapshot.
"""
from repro_torch.serving.array_cache import ArrayResultCache
from repro_torch.serving.batcher import (BucketConfig, MicroBatch,
                                         PendingRequest, ShapeBucketBatcher,
                                         bucket_size_for)
from repro_torch.serving.cache import LRUResultCache, canonical_query_key
from repro_torch.serving.engine import (SLAB_ADMISSION_REJECT,
                                        SLAB_CACHED_ONLY_MISS, SLAB_OK,
                                        AdmissionError, CacheOnlyMiss,
                                        EngineConfig, ServeEngine,
                                        ServeResponse)
from repro_torch.serving.executor import (ROLLOUT_BACKENDS, ShardedExecutor,
                                          available_backends,
                                          register_rollout_backend,
                                          resolve_rollout_backend)
from repro_torch.serving.levels import EXECUTED_LEVELS, ServiceLevel
from repro_torch.serving.slab import QueryKeyCache, TicketSlab
from repro_torch.serving.telemetry import Telemetry

__all__ = [
    "AdmissionError", "ArrayResultCache", "BucketConfig", "CacheOnlyMiss",
    "EXECUTED_LEVELS", "EngineConfig", "LRUResultCache", "MicroBatch",
    "PendingRequest", "QueryKeyCache", "ROLLOUT_BACKENDS", "SLAB_ADMISSION_REJECT",
    "SLAB_CACHED_ONLY_MISS", "SLAB_OK", "ServeEngine", "ServeResponse",
    "ServiceLevel", "ShapeBucketBatcher", "ShardedExecutor", "Telemetry",
    "TicketSlab", "available_backends", "bucket_size_for",
    "canonical_query_key", "register_rollout_backend",
    "resolve_rollout_backend",
]
