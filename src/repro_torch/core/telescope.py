"""Telescoping cascade (paper Fig. 1): L0 match → L1 rank/prune → L2.

On a multi-shard index the per-shard candidate buffers are merged by
static rank before L1.  Sorts are stable so that ties break toward the
lower index, as ``jax.lax.top_k`` and ``jnp.argsort`` do in the
reference (``torch.topk`` promises no tie order).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["l1_prune", "merge_shard_candidates"]

_INT32_MAX = 2**31 - 1


def l1_prune(scores_all: torch.Tensor,  # (B, n_docs_padded) L1 scores
             cand: torch.Tensor,        # (B, K) int32 doc ids, -1 pad
             keep: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank candidates by L1 score, prune to ``keep``.  Returns
    (doc_ids (B, keep) int32, scores (B, keep)) sorted descending."""
    s = torch.gather(scores_all, 1, torch.clamp(cand, min=0).long())
    s = torch.where(cand >= 0, s, float("-inf"))
    top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :keep], top_i[:, :keep]
    top_ids = torch.gather(cand, 1, top_i)
    top_ids = torch.where(torch.isfinite(top_s), top_ids, -1)
    return top_ids, top_s


def merge_shard_candidates(shard_cand: torch.Tensor,  # (S, B, K) global ids
                           keep: int = 512) -> torch.Tensor:
    """Merge per-shard buffers by global static rank (= ascending doc id,
    because documents are laid out in static-rank order)."""
    s, b, k = shard_cand.shape
    flat = shard_cand.permute(1, 0, 2).reshape(b, s * k)
    key = torch.where(flat >= 0, flat, _INT32_MAX)
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.gather(flat, 1, order[:, :keep])
