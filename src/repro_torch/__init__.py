"""PyTorch + CUDA port of ``repro`` (the JAX + Pallas reference).

The layout mirrors ``repro`` module for module
(``repro/core/rollout.py`` -> ``repro_torch/core/rollout.py``).  This
package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.

Device rule: entry points (``RetrievalSystem(cfg, device=...)``,
``ShardedExecutor``, kernel wrappers, and every helper that creates
tensors from nothing) run on ``cuda`` unless the caller passes
``device="cpu"``.  Without CUDA they raise; they never fall back to the
CPU quietly.  A kernel wrapper given CPU tensors runs its plain torch
version; given CUDA tensors it launches its hand-written kernel or
raises.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
