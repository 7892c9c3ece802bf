"""Device meshes (the reference's ``launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a ``torch.distributed`` ``DeviceMesh`` with
named dims, one rank per device, over the default process group, which
the caller initialises first (``torch.distributed.init_process_group``
with its own rank, world size and rendezvous).  A mesh on ``cuda``
(the default) runs its collectives over NCCL, one rank per card of this
host; a mesh on ``cpu`` over gloo.  A world with more ranks than cards
raises: NCCL cannot put two ranks on one card, and nothing shares a
card or moves to gloo quietly.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "make_mesh"]


def make_mesh(shape: Sequence[int], names: Sequence[str], device=None):
    """A ``DeviceMesh`` of ``shape`` over the default process group,
    whose world size must be the shape's product.  On ``cuda``, rank r
    takes card r of this host."""
    dev = resolve_device(device)
    if dev.type == "meta":
        raise ValueError("a mesh needs a cpu or cuda device")
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the world "
                         f"has {world}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"{world} ranks need {world} cards, one each; this host has "
                f"{cards} (NCCL cannot put two ranks on one card)")
        torch.cuda.set_device(rank)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 (``data``, ``model``) = one 256-chip pod; 2 x 16 x 16
    (``pod``, ``data``, ``model``) = two pods (512 ranks)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A (``data``, ``model``) mesh over the world's ranks: the CPU tests'
    eight gloo ranks, or one rank per card."""
    return make_mesh((data, model), ("data", "model"), device)
