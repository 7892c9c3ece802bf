"""Checkpoints and the fault-tolerant loop (the single-device half of
the reference's ``distributed/``; its sharding, collectives, elastic
and embedding modules wait for the mesh port)."""
from .checkpoint import CheckpointManager, latest_step, restore, save
from .fault_tolerance import (FailureInjector, FaultToleranceConfig,
                              run_resilient_loop)

__all__ = ["CheckpointManager", "save", "restore", "latest_step",
           "FaultToleranceConfig", "FailureInjector", "run_resilient_loop"]
