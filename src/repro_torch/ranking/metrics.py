"""Candidate-set quality (paper §5): NCG — NDCG without position
discounting, because L0 candidate sets are unordered (Eq. 5–6)::

    CumGain = Σ_{i=1..|D|} gain_i ,  NCG = CumGain / CumGain_ideal

|D| capped at 100 (candidates kept in scan order = static-rank order).
Paired relative deltas and a sign-permutation significance test
(numpy) reproduce Table 1's reporting.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ncg_at_k", "batched_ncg", "relative_delta",
           "paired_permutation_pvalue"]


def ncg_at_k(cand: torch.Tensor,          # (K,) int32 doc ids, -1 pad
             judged_ids: torch.Tensor,    # (J,) int32, -1 pad
             judged_gains: torch.Tensor,  # (J,)
             k: int = 100) -> torch.Tensor:
    """NCG@k of one query, a 0-d float32: a row of :func:`batched_ncg`."""
    return batched_ncg(cand[None], judged_ids[None], judged_gains[None], k)[0]


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


def relative_delta(treatment: np.ndarray, baseline: np.ndarray) -> float:
    """Mean relative change, as Table 1 reports (%)."""
    b = np.mean(baseline)
    return float((np.mean(treatment) - b) / max(b, 1e-9) * 100.0)


def paired_permutation_pvalue(treatment: np.ndarray, baseline: np.ndarray,
                              n_perm: int = 2000, seed: int = 0) -> float:
    """Two-sided paired sign-permutation test on the per-query deltas."""
    rng = np.random.default_rng(seed)
    d = np.asarray(treatment, np.float64) - np.asarray(baseline, np.float64)
    obs = abs(d.mean())
    signs = rng.choice([-1.0, 1.0], size=(n_perm, len(d)))
    null = np.abs((signs * d[None, :]).mean(axis=1))
    return float((np.sum(null >= obs) + 1) / (n_perm + 1))
