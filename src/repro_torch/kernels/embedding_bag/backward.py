"""Gradients of the row gathers, summed in a fixed order.

The backward of a gather that reads some rows several times adds
several rows into one.  PyTorch's own backwards of ``index_select`` and
of the bag's plain version add with ``index_add_``, whose order on CUDA
is that of atomics: two steps may not give the same bits.  Here the ids
are sorted stably, each run of one id is summed by ``segment_reduce``
(one thread a (segment, column), in id order), and each sum is written
once, so a backward gives the same bits every time.  Sums are float32,
cast once to the table's dtype.

The reference has no backward kernel: its gradients are autodiff of
``jnp.take`` and of ``embedding_bag_ref``.  These are that autodiff's
functions, in plain torch on both devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cost import note

__all__ = ["scatter_rows", "take_rows", "embedding_bag_backward"]


def scatter_rows(rows: torch.Tensor, ids: torch.Tensor, n_rows: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """rows (N, E) summed into a zero (n_rows, E) tensor at ``ids`` (N,),
    in ``dtype``; an id < 0 or >= n_rows adds nothing.  The order of the
    sum is fixed (see the module's note)."""
    e = rows.shape[1]
    out = torch.zeros((n_rows + 1, e), dtype=torch.float32, device=rows.device)
    if rows.shape[0]:
        ids = ids.long()
        ids = torch.where((ids >= 0) & (ids < n_rows), ids, n_rows)
        order = torch.sort(ids, stable=True).indices
        if ids.device.type == "meta":
            # the runs depend on the ids: a dry run takes each id as a
            # run of its own, the most rows the sum can write
            note("scatter_rows: data-dependent runs of one id, each id "
                 "counted as its own run (the worst case)")
            uniq, counts = ids[order], torch.ones_like(ids)
        else:
            uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
        out[uniq] = torch.segment_reduce(rows.float()[order], "sum",
                                         lengths=counts, axis=0, unsafe=True)
    return out[:n_rows].to(dtype)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, table.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        rows = grad.reshape(-1, grad.shape[-1])
        return scatter_rows(rows, idx.reshape(-1), ctx.n_rows, grad.dtype), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a (V, E) table and integer ids of any shape
    (every id in [0, V)): the same values, and a backward that sums in a
    fixed order (``scatter_rows``)."""
    return _TakeRows.apply(table, idx)


def embedding_bag_backward(grad_out: torch.Tensor, indices: torch.Tensor,
                           weights, n_rows: int, mode: str = "sum",
                           table=None):
    """The gradients of ``embedding_bag`` (B, E) for ``grad_out`` (B, E):
    (the table's (n_rows, E) in grad_out's dtype, the weights' (B, L)
    float32 or None).

    Each id >= 0 adds its bag's grad_out row times its weight (1 when
    there are none), divided by the bag's count of ids >= 0 (at least 1)
    for "mean", as autodiff of the reference's ``embedding_bag_ref``
    gives; -1 padding adds nothing, and neither does an id at or past
    ``n_rows``, as ``jnp.take``'s NaN fill passes no gradient to the
    table.  The weights' gradient (of an id >= 0: its row's dot product
    with the bag's scaled grad_out row, NaN for an id past the table, as
    its row is; 0 for padding) needs ``table``; without it, None."""
    valid = indices >= 0
    g = grad_out.float()
    if mode == "mean":
        g = g / valid.sum(dim=1, keepdim=True).clamp_min(1)
    w = valid.float() if weights is None else torch.where(valid, weights.float(), 0.0)
    contrib = g[:, None, :] * w[..., None]                        # (B, L, E)
    grad_table = scatter_rows(contrib.reshape(-1, g.shape[1]),
                              indices.reshape(-1).long(), n_rows, grad_out.dtype)
    grad_w = None
    if weights is not None and table is not None:
        inside = valid & (indices < n_rows)
        safe = torch.where(inside, indices, torch.zeros_like(indices))
        rows = table[safe.long()].float()
        rows = rows.masked_fill((valid & ~inside)[..., None], float("nan"))
        grad_w = torch.where(valid, (rows * g[:, None, :]).sum(-1), 0.0)
    return grad_table, grad_w
