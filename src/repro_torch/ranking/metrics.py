"""Candidate-set quality (paper §5): NCG — NDCG without position
discounting, because L0 candidate sets are unordered (Eq. 5–6)::

    CumGain = Σ_{i=1..|D|} gain_i ,  NCG = CumGain / CumGain_ideal

|D| capped at 100 (candidates kept in scan order = static-rank order).
"""
from __future__ import annotations

import torch

__all__ = ["batched_ncg"]


def batched_ncg(cand: torch.Tensor,          # (B, K) int32, -1 pad
                judged_ids: torch.Tensor,    # (B, J) int32, -1 pad
                judged_gains: torch.Tensor,  # (B, J)
                k: int = 100) -> torch.Tensor:
    """NCG@k per query, (B,) float32."""
    gains_j = judged_gains.to(torch.float32)
    cand_k = cand[:, :k]
    j_valid = judged_ids >= 0
    eq = (cand_k[:, :, None] == judged_ids[:, None, :]) & j_valid[:, None, :]
    gains = torch.where(eq, gains_j[:, None, :], 0.0).sum(dim=2)
    cum_gain = torch.where(cand_k >= 0, gains, 0.0).sum(dim=1)
    ideal_sorted = torch.sort(torch.where(j_valid, gains_j, 0.0), dim=1,
                              descending=True).values
    ideal = ideal_sorted[:, :k].sum(dim=1)
    safe = torch.where(ideal > 0, ideal, 1.0)
    return torch.where(ideal > 0, cum_gain / safe, 0.0)
