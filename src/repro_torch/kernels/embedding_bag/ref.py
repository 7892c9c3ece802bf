"""Plain PyTorch version of EmbeddingBag (gather + masked reduce).

The same function as the reference's oracle ``embedding_bag_ref``: rows
gathered and summed in float32, index -1 (any index < 0) is padding
with weight 0, "mean" divides by max(count of indices >= 0, 1), the
result in the table's dtype.  An index at or past V, which no model
produces, is valid as in the reference, whose ``jnp.take`` fills its
row with NaN: the bag's row is NaN in every column, whatever its
weights, and the index counts in the mean's divisor.  The CUDA kernels
give the same without reading outside the table.
The recsys models' CPU path, the CPU tests and ``chip_smoke.py``'s
comparison use it; the wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag_ref"]


def embedding_bag_ref(table, indices, weights=None, *, mode: str = "sum"):
    """table (V, E), indices (B, L) int (< 0 = padding, >= V = a NaN
    row), weights (B, L) float32 or None → (B, E) in table's dtype."""
    valid = indices >= 0
    inside = valid & (indices < table.shape[0])
    safe = torch.where(inside, indices, torch.zeros_like(indices))
    rows = table[safe.long()].float()                           # (B, L, E)
    rows = rows.masked_fill((valid & ~inside)[..., None], float("nan"))
    if weights is None:
        w = valid.float()
    else:
        w = torch.where(valid, weights.float(), 0.0)
    out = (rows * w[..., None]).sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp_min(1)
    return out.to(table.dtype)
