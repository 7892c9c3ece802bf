"""The L1 ranker (forward) — first rank-and-prune stage (paper §3).

A small MLP over query-document features; its score is the paper's
``g(d)`` inside the reward (Eq. 3) and the ranking function for
candidate pruning.  The parameters are a dict of tensors, as in the
reference.  Training (``train_l1``, Adam) is not ported yet; trained
parameters arrive through ``repro_torch.weights``.
The matmuls are plain ``torch.matmul`` in float32 (TF32 off, see
``repro_torch.device``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .features import FEATURE_DIM, doc_features

__all__ = ["init_l1", "l1_score", "score_all_docs", "idf_for_terms"]

Params = Dict[str, torch.Tensor]


def init_l1(generator: torch.Generator, hidden: int = 32,
            feature_dim: int = FEATURE_DIM, device="cpu") -> Params:
    """Random init from a CPU ``torch.Generator`` (the reference's
    ``jax.random`` draws cannot be reproduced; load those through
    ``repro_torch.weights`` instead)."""
    s1 = 1.0 / np.sqrt(feature_dim)
    s2 = 1.0 / np.sqrt(hidden)

    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float32)

    params = {
        "w1": normal(feature_dim, hidden) * s1,
        "b1": torch.zeros(hidden),
        "w2": normal(hidden, hidden) * s2,
        "b2": torch.zeros(hidden),
        "w3": normal(hidden, 1) * s2,
        "b3": torch.zeros(1),
    }
    return {k: v.to(device) for k, v in params.items()}


def l1_score(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """(..., FEATURE_DIM) -> (...,) score in (0, 1)."""
    h = torch.relu(feats @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return torch.sigmoid((h @ params["w3"] + params["b3"])[..., 0])


def score_all_docs(params, occ, idf, term_present, static_rank, doc_len):
    """g(d) for every document of each query's occupancy:
    (Q, n_blocks, T, F, W) -> (Q, n_docs_padded) float32."""
    return l1_score(params, doc_features(occ, idf, term_present,
                                         static_rank, doc_len))


def idf_for_terms(df_body: np.ndarray, n_docs: int, terms: np.ndarray) -> np.ndarray:
    """Per-query-slot IDF, 0 for padded slots. terms: (Q, T) with -1 pad."""
    safe = np.clip(terms, 0, None)
    idf = np.log(n_docs / (1.0 + df_body[safe]))
    return np.where(terms >= 0, idf, 0.0).astype(np.float32)
