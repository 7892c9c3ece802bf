"""Sharding and fault tolerance (the reference's ``distributed/``):
the partition-spec rules per family, the collectives and gradient
compression, the sharded embedding ops, elastic re-meshing, and
checkpoints that restore onto a mesh.  The LM's tensor, FSDP and
sequence sharding and the GNN's edge sharding, which the reference
leaves to its partitioner, are written out over these collectives in
``models/transformer.py`` and ``models/gnn.py``."""
from .sharding_rules import (
    P, NamedSharding, PartitionSpec, data_axes, gnn_param_specs,
    kv_cache_specs, lm_param_specs, recsys_param_specs, spec_tree,
    to_placements, zero1_state_specs,
)
from .checkpoint import CheckpointManager, latest_step, restore, save
from .fault_tolerance import (FailureInjector, FaultToleranceConfig,
                              run_resilient_loop)
from .collectives import (
    compress_with_feedback, compressed_psum_grads, decompress_accumulate,
    zeros_like_residual,
)
from .elastic import (place_tree, plan_mesh, plan_mesh_shape, reshard_tree,
                      validate_specs)
from .embedding_ops import sharded_bag_sum, sharded_lookup, sharded_lookup_rs

__all__ = ["data_axes", "lm_param_specs", "zero1_state_specs",
           "kv_cache_specs", "gnn_param_specs", "recsys_param_specs",
           "spec_tree", "PartitionSpec", "P", "NamedSharding", "to_placements",
           "CheckpointManager", "save", "restore", "latest_step",
           "FaultToleranceConfig", "FailureInjector", "run_resilient_loop",
           "compress_with_feedback", "decompress_accumulate",
           "compressed_psum_grads", "zeros_like_residual", "plan_mesh",
           "plan_mesh_shape", "validate_specs", "reshard_tree", "place_tree",
           "sharded_lookup", "sharded_bag_sum", "sharded_lookup_rs"]
