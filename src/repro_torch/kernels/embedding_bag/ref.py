"""Plain PyTorch version of EmbeddingBag (gather + masked reduce).

The same function as the reference's oracle ``embedding_bag_ref``: rows
gathered and summed in float32, index -1 is padding with weight 0,
"mean" divides by max(valid count, 1), the result in the table's dtype.
An index at or past V, which no model produces and which the reference
fills with NaN, is padding here as in the CUDA kernel, so the two agree
on every input.
The recsys models' CPU path, the CPU tests and ``chip_smoke.py``'s
comparison use it; the wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag_ref"]


def embedding_bag_ref(table, indices, weights=None, *, mode: str = "sum"):
    """table (V, E), indices (B, L) int (-1 or >= V = padding), weights
    (B, L) float32 or None → (B, E) in table's dtype."""
    valid = (indices >= 0) & (indices < table.shape[0])
    safe = torch.where(valid, indices, torch.zeros_like(indices))
    rows = table[safe.long()].float()                           # (B, L, E)
    if weights is None:
        w = valid.float()
    else:
        w = torch.where(valid, weights.float(), 0.0)
    out = (rows * w[..., None]).sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp_min(1)
    return out.to(table.dtype)
