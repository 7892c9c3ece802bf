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
  region");
- ``gather_replicated``: the ranks' blocks joined into a tensor that is
  replicated from there on, backward this rank's own block (Megatron's
  "gather from the model-parallel region");
- ``copy_to``: the identity, whose backward is a sum over the axes
  (Megatron's "copy to the model-parallel region"): it marks where a
  tensor replicated over the axes enters work split over them, so that
  the ranks' partial cotangents are added up there;
- ``pmax``: an all-reduce MAX, whose backward sends the cotangent to the
  ranks that hold the maximum, split evenly over them (the tie rule of
  ``jax.ops.segment_max`` and of ``torch.amax``);
- ``psum_ordered``: the sum over the ranks in rank order (an all-gather,
  then a left fold over the ranks), the same bits on every run; its
  backward passes the cotangent through, as ``psum``'s.

Every all-reduce, all-gather and reduce-scatter here, forward or
backward, goes through ``obs.trace.collective``: it adds one to
``collectives()`` and, under an active tracer, opens a ``collective``
span (``op``, ``axis``, the bytes this rank puts in).

Which sum is which.  NCCL's and gloo's all-reduce fix no order of the
additions, so a float sum that must come out the same on every run goes
through ``psum_ordered`` (or ``copy_to(ordered=True)``): the GNN's
edge-partial aggregates and their backward, and the squared norms of
``train/optimizer.py``'s sharded ``global_norm``.  The LM's tensor and
sequence parallel collectives (the row-parallel sums, the reduce-
scatters, the vocab-parallel cross-entropy's sums) and the gradient
sums over the batch's axes are ``psum`` / ``psum_scatter``: they move
whole activations, and a gather of every rank's copy would cost the
axis size in memory.  Integer sums (counts) are exact in any order.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.obs.trace import collective
from repro_torch.train.tree import tree_map

from .sharding_rules import PartitionSpec, mesh_shape, to_placements

__all__ = ["shard_in", "shard_out", "axis_index", "psum", "pmean",
           "all_gather", "psum_scatter", "psum_ordered", "pmax", "copy_to",
           "scatter_replicated", "gather_replicated", "compress_with_feedback",
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


def _all_reduce(x: torch.Tensor, group, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced in place over ``group``, the mesh axis ``axis``."""
    name = "all_reduce" if op == dist.ReduceOp.SUM else "all_reduce_max"
    with collective(name, axis, x.nbytes):
        dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather_dim(x: torch.Tensor, group, dim: int, axis: str) -> torch.Tensor:
    """The ranks' blocks joined along ``dim``, contiguous: a strided view
    would send the next GEMM down another cuBLAS path than the unsharded
    layout's (float32 results 4e-6 apart on the H100 at world size 1)."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    with collective("all_gather", axis, xt.nbytes):
        dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int, axis: str) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by {n}")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    with collective("reduce_scatter", axis, xt.nbytes):
        dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        return _all_reduce(x.contiguous().clone(), group, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, axis):
        ctx.group, ctx.dim, ctx.axis = group, dim, axis
        return _all_gather_dim(x, group, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return (_reduce_scatter_dim(grad, ctx.group, ctx.dim, ctx.axis),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, axis):
        ctx.group, ctx.dim, ctx.axis = group, dim, axis
        return _reduce_scatter_dim(x, group, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return (_all_gather_dim(grad, ctx.group, ctx.dim, ctx.axis),
                None, None, None)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, axis):
        ctx.group, ctx.dim, ctx.axis = group, dim, axis
        return _own_block(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return (_all_gather_dim(grad, ctx.group, ctx.dim, ctx.axis),
                None, None, None)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, axis):
        ctx.group, ctx.dim = group, dim
        return _all_gather_dim(x, group, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, ctx.group, ctx.dim), None, None, None


def _sum_in_rank_order(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    parts = _all_gather_dim(x.contiguous()[None], group, 0, axis)
    out = parts[0].clone()
    for i in range(1, n):
        out += parts[i]
    return out


class _PSumOrdered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        return _sum_in_rank_order(x, group, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ordered, axis):
        ctx.group, ctx.ordered, ctx.axis = group, ordered, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.ordered:
            return (_sum_in_rank_order(grad, ctx.group, ctx.axis),
                    None, None, None)
        return (_all_reduce(grad.contiguous().clone(), ctx.group, ctx.axis),
                None, None, None)


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        out = _all_reduce(x.contiguous().clone(), group, axis,
                          op=dist.ReduceOp.MAX)
        ctx.group, ctx.axis = group, axis
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        hit = (x == out).to(grad.dtype)
        ties = _all_reduce(hit.clone(), ctx.group, ctx.axis)  # small integers: exact
        return grad * hit / ties.clamp_min(1), None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes``; the backward passes the cotangent through."""
    for a in _axes(axes):
        x = _PSum.apply(x, mesh.get_group(a), a)
    return x


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``psum`` over each axis in turn, divided by its size."""
    for a in _axes(axes):
        x = psum(x, mesh, a) / mesh_shape(mesh)[a]
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s ranks concatenated along ``dim`` (tiled);
    backward: a reduce-scatter."""
    return _AllGather.apply(x, mesh.get_group(axis), dim, axis)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Sum over ``axis``, this rank keeping its block of ``dim`` (tiled);
    backward: an all-gather."""
    return _ReduceScatter.apply(x, mesh.get_group(axis), dim, axis)


def psum_ordered(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``psum`` with a fixed order: over each axis in turn, the ranks'
    tensors gathered and added in rank order, so that every rank gets
    the same bits on every run.  It gathers the axis size times ``x``'s
    memory.  Backward: the cotangent passes through."""
    for a in _axes(axes):
        x = _PSumOrdered.apply(x, mesh.get_group(a), a)
    return x


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum over ``axes``; backward: the cotangent to
    the ranks whose element is the maximum, split evenly over them."""
    for a in _axes(axes):
        x = _PMax.apply(x, mesh.get_group(a), a)
    return x


def copy_to(x: torch.Tensor, mesh, axes, ordered: bool = False) -> torch.Tensor:
    """The identity; backward: the cotangent summed over ``axes`` (in
    rank order with ``ordered``).  Put it where a tensor replicated over
    ``axes`` feeds work split over them."""
    for a in _axes(axes):
        x = _CopyTo.apply(x, mesh.get_group(a), ordered, a)
    return x


def scatter_replicated(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor replicated over
    ``axis``; backward: an all-gather."""
    return _Scatter.apply(x, mesh.get_group(axis), dim, axis)


def gather_replicated(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s ranks joined along ``dim``, for work that
    every rank then does whole (the inverse of ``scatter_replicated``);
    backward: this rank's own block of the cotangent, which every rank
    holds whole."""
    return _Gather.apply(x, mesh.get_group(axis), dim, axis)


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
        return _all_reduce(p.contiguous().clone(), mesh.get_group(axis), axis) / n

    return decompress_accumulate(tree_map(mean, payload)), new_res


def zeros_like_residual(grads: PyTree) -> PyTree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
