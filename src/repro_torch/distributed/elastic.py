"""Elastic scaling: re-mesh and re-shard when the device pool changes
(the reference's ``distributed/elastic.py``).

Checkpoints store LOGICAL (unsharded) arrays (``checkpoint.py``), so a
job preempted on 2 x 16 x 16 can resume on 16 x 16 (or any
factorization): build the new mesh, re-derive the specs from the same
rules, ``reshard_tree``.  Divisibility is validated up front so a bad
pool fails fast with a report.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, List

from repro_torch.device import mesh_device
from repro_torch.train.tree import tree_leaves, tree_map

from .collectives import shard_in, shard_out
from .sharding_rules import PartitionSpec, mesh_shape

__all__ = ["plan_mesh", "plan_mesh_shape", "validate_specs", "reshard_tree",
           "place_tree"]


def plan_mesh_shape(n_devices: int, prefer_model: int = 16):
    """Largest model-axis ≤ prefer_model that divides n_devices."""
    for m in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % m == 0:
            return (n_devices // m, m)
    raise ValueError(f"cannot factor {n_devices} devices")


def plan_mesh(n_devices: int, prefer_model: int = 16, device=None):
    """A (data, model) mesh for an arbitrary rank count."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(plan_mesh_shape(n_devices, prefer_model),
                     ("data", "model"), device)


def validate_specs(tree: Any, specs: Any, mesh) -> List[str]:
    """Human-readable problems (empty list = clean).  ``mesh`` is a
    ``DeviceMesh`` or an ``{axis: size}`` mapping."""
    shape = mesh_shape(mesh)
    problems = []
    # (leaf, spec) pairs in the tree's flatten order
    pairs = tree_leaves(tree_map(lambda l, s: SimpleNamespace(leaf=l, spec=s),
                                 tree, specs))
    for pair in pairs:
        if not isinstance(pair.spec, PartitionSpec):
            continue
        lshape = tuple(pair.leaf.shape)
        for dim, axis in enumerate(pair.spec):
            if axis is None:
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            size = 1
            for a in axes:
                size *= shape[a]
            if dim >= len(lshape) or lshape[dim] % size != 0:
                problems.append(f"dim {dim} of shape {lshape} not divisible "
                                f"by {axes}={size}")
    return problems


def reshard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf, a logical tensor the same on every rank, as the DTensor
    of its spec on ``mesh``, on the mesh's device: each rank copies its
    own block (``distribute_tensor`` without its scatter from rank 0, and
    without a second full-size buffer); a leaf whose spec is not a
    ``PartitionSpec`` is copied whole.  The result shares no memory with
    ``tree`` (a train step updates its arguments in place), as
    ``jax.device_put`` makes new buffers.  A ``meta`` leaf (a dry run)
    stays on meta: its block is a meta tensor of the block's shape."""
    mesh_dev = mesh_device(mesh)

    def place(leaf, spec):
        dev = leaf.device if leaf.device.type == "meta" else mesh_dev
        if not isinstance(spec, PartitionSpec):
            return leaf.to(dev, copy=True)
        block = shard_in(leaf, mesh, spec).to(dev, copy=True).contiguous()
        return shard_out(block, mesh, spec)

    return tree_map(place, tree, specs)


def place_tree(tree: Any, shardings: Any) -> Any:
    """``reshard_tree`` with a matching tree of ``NamedSharding``s (each
    names its mesh), as ``jax.device_put(tree, shardings)``; a leaf whose
    sharding is None stays as it is."""
    return tree_map(lambda t, s: t if s is None else reshard_tree(t, s.spec, s.mesh),
                    tree, shardings)
