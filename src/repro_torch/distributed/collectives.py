"""Collectives over a ``DeviceMesh``: the port's ``shard_map`` in and out,
the ``jax.lax`` collectives as autograd functions, and the reference's
``distributed/collectives.py`` (bf16 gradient compression with fp32
error feedback).

``shard_in(x, mesh, spec)`` is the block of ``x`` that ``shard_map``
hands this rank under ``spec``: a DTensor is redistributed to the
spec's placements (a replicated one just takes its block); a plain
tensor is the global value, the same on every rank, and is sliced.
``shard_out(local, mesh, spec)`` wraps a rank's result as the DTensor
of the reference's ``out_specs``.

The collectives act over one named mesh axis (or a tuple of them, in
turn) on ``mesh.get_group(axis)``, and each has the backward that keeps
every rank's gradient right when the ranks along the axis compute the
same loss (activations replicated over ``model`` between blocks, as in
Megatron):

- ``psum``: an all-reduce whose backward passes the cotangent through
  (Megatron's "reduce from the model-parallel region"); ``pmean`` divides
  it by the axis size;
- ``all_gather``: ``jax.lax.all_gather(tiled=True)``, whose backward is a
  reduce-scatter (the gradient of a gathered weight read by different
  tokens on each rank, as FSDP's);
- ``psum_scatter``: ``jax.lax.psum_scatter(tiled=True)``, backward an
  all-gather;
- ``scatter_replicated``: this rank's block of a replicated tensor,
  backward an all-gather (Megatron's "scatter to the model-parallel
  region").
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.train.tree import tree_map

from .sharding_rules import PartitionSpec, mesh_shape, to_placements

__all__ = ["shard_in", "shard_out", "axis_index", "psum", "pmean",
           "all_gather", "psum_scatter",
           "scatter_replicated", "compress_with_feedback",
           "decompress_accumulate", "compressed_psum_grads",
           "zeros_like_residual"]

PyTree = Any


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _block(x: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of a global tensor: each dim cut into as many
    equal parts as its axes' sizes multiply to, the part at this rank's
    coordinates (the first axis major)."""
    shape = mesh_shape(mesh)
    for d, e in enumerate(spec):
        axes = _axes(e) if e is not None else ()
        n, i = 1, 0
        for a in axes:
            n, i = n * shape[a], i * shape[a] + axis_index(mesh, a)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of shape {tuple(x.shape)} does not "
                             f"divide by {axes} = {n}")
        size = x.shape[d] // n
        x = x.narrow(d, i * size, size)
    return x


def shard_in(x, mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (``shard_map``'s in_specs)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        placements = to_placements(spec, mesh)
        if tuple(x.placements) != placements:
            x = x.redistribute(mesh, placements)
        return x.to_local()
    return _block(x, mesh, spec)


def shard_out(local: torch.Tensor, mesh, spec: PartitionSpec):
    """The DTensor whose block on this rank is ``local`` under ``spec``
    (``shard_map``'s out_specs; every rank's block has the same shape)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False)


def _all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by {n}")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_dim(grad, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_dim(grad, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_block(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_dim(grad, ctx.group, ctx.dim), None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes``; the backward passes the cotangent through."""
    for a in _axes(axes):
        x = _PSum.apply(x, mesh.get_group(a))
    return x


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``psum`` over each axis in turn, divided by its size."""
    for a in _axes(axes):
        x = psum(x, mesh, a) / mesh_shape(mesh)[a]
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s ranks concatenated along ``dim`` (tiled);
    backward: a reduce-scatter."""
    return _AllGather.apply(x, mesh.get_group(axis), dim)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Sum over ``axis``, this rank keeping its block of ``dim`` (tiled);
    backward: an all-gather."""
    return _ReduceScatter.apply(x, mesh.get_group(axis), dim)


def scatter_replicated(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor replicated over
    ``axis``; backward: an all-gather."""
    return _Scatter.apply(x, mesh.get_group(axis), dim)


# ------------------------------------------------ gradient compression
def compress_with_feedback(grads: PyTree, residual: PyTree) -> Tuple[PyTree, PyTree]:
    """fp32 grads + carried residual -> (bf16 payload, new residual)."""
    payload = tree_map(lambda g, r: (g.float() + r).to(torch.bfloat16),
                       grads, residual)
    new_res = tree_map(lambda g, r, p: (g.float() + r) - p.float(),
                       grads, residual, payload)
    return payload, new_res


def decompress_accumulate(payload: PyTree) -> PyTree:
    return tree_map(lambda p: p.float(), payload)


def compressed_psum_grads(grads: PyTree, residual: PyTree, mesh,
                          axis: str = "data"):
    """For data-parallel loops: compress -> mean over ``axis`` in bf16 (an
    all-reduce of the payload, then a division by the axis size, as the
    reference's ``pmean``) -> decompress.  Returns (mean grads fp32, new
    residual)."""
    payload, new_res = compress_with_feedback(grads, residual)
    n = mesh_shape(mesh)[axis]

    def mean(p):
        p = p.contiguous().clone()
        dist.all_reduce(p, group=mesh.get_group(axis))
        return p / n

    return decompress_accumulate(tree_map(mean, payload)), new_res


def zeros_like_residual(grads: PyTree) -> PyTree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
