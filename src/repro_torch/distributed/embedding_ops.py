"""Distributed embedding lookup, the sharded EmbeddingBag (the
reference's ``distributed/embedding_ops.py``).

Tables row-shard over ``model``: each rank gathers the rows of its own
block (the ids outside it masked), and one collective over ``model``
joins the partials, so the table is never gathered.  The ``*_local``
functions are the reference's ``shard_map`` bodies on this rank's
blocks, for callers that already hold them (``models/recsys.py``); the
others take DTensors (or global tensors) and return DTensors with the
reference's out specs.

The gather is ``take_rows`` (plain torch, as the reference's
``jnp.take`` lies outside any kernel); the bag's partial is the port's
``embedding_bag`` with the out-of-shard ids set to -1, which on a CUDA
tensor launches the hand-written bag kernel.  Both sum their gradients
in a fixed order; the ``psum`` passes its cotangent through, so a
block's gradient is that of the rows of this rank's batch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import embedding_bag, take_rows

from .collectives import axis_index, psum, psum_scatter, shard_in, shard_out
from .sharding_rules import P

__all__ = ["sharded_lookup", "sharded_lookup_rs", "sharded_bag_sum",
           "lookup_local", "lookup_rs_local", "bag_sum_local"]


def _masked_rows(tbl: torch.Tensor, ids: torch.Tensor, mesh, model_axis):
    """This block's rows of ``ids`` (global row ids), zero where the id
    lies in another rank's block."""
    vloc = tbl.shape[0]
    loc = ids.long() - axis_index(mesh, model_axis) * vloc
    ok = (loc >= 0) & (loc < vloc)
    rows = take_rows(tbl, loc.clamp(0, vloc - 1))
    return rows * ok[..., None].to(rows.dtype)


def lookup_local(tbl, ids, mesh, model_axis: str = "model") -> torch.Tensor:
    """(B_loc, F) ids against this rank's (V/M, E) block → (B_loc, F, E),
    summed over ``model``."""
    return psum(_masked_rows(tbl, ids, mesh, model_axis), mesh, model_axis)


def lookup_rs_local(tbl, ids, mesh, model_axis: str = "model",
                    dim: int = 0) -> torch.Tensor:
    """As ``lookup_local``, reduce-scattered over ``model`` along the
    ids' dim ``dim``: this rank keeps its (B_loc/M, F, E) rows (the LM's
    sequence-parallel embedding keeps its S/M positions, ``dim=1``)."""
    return psum_scatter(_masked_rows(tbl, ids, mesh, model_axis), mesh,
                        model_axis, dim)


def bag_sum_local(tbl, ids, mesh, model_axis: str = "model") -> torch.Tensor:
    """EmbeddingBag(sum) of (B_loc, L) ids (-1 = padding) against this
    rank's block → (B_loc, E), summed over ``model``."""
    vloc = tbl.shape[0]
    loc = ids - axis_index(mesh, model_axis) * vloc
    ok = (loc >= 0) & (loc < vloc) & (ids >= 0)
    local_ids = torch.where(ok, loc, -1).to(torch.int32)
    return psum(embedding_bag(tbl, local_ids, mode="sum"), mesh, model_axis)


def _ids_spec(data_axes):
    return P(data_axes, None) if data_axes else P()


def sharded_lookup(table, idx, mesh, data_axes=("data",),
                   model_axis: str = "model"):
    """table (V, E) sharded P(model, None); idx (B, F) sharded over the
    data axes.  Returns (B, F, E) embeddings sharded over them."""
    out = lookup_local(shard_in(table, mesh, P(model_axis, None)),
                       shard_in(idx, mesh, _ids_spec(data_axes)), mesh,
                       model_axis)
    return shard_out(out, mesh, P(data_axes, None, None) if data_axes else P())


def sharded_bag_sum(table, idx, mesh, data_axes=("data",),
                    model_axis: str = "model"):
    """EmbeddingBag(sum) over a row-sharded table: (B, L) ids → (B, E)."""
    out = bag_sum_local(shard_in(table, mesh, P(model_axis, None)),
                        shard_in(idx, mesh, P(data_axes, None)), mesh,
                        model_axis)
    return shard_out(out, mesh, P(data_axes, None))


def sharded_lookup_rs(table, idx, mesh, data_axes=("data",),
                      model_axis: str = "model"):
    """Reduce-scatter lookup: idx (B, F) sharded over data → (B, F, E)
    sharded over data + model, so that the dense tower downstream runs
    on B/(dp·model) rows a rank."""
    out = lookup_rs_local(shard_in(table, mesh, P(model_axis, None)),
                          shard_in(idx, mesh, P(data_axes, None)), mesh,
                          model_axis)
    return shard_out(out, mesh, P(tuple(data_axes) + (model_axis,), None, None))
