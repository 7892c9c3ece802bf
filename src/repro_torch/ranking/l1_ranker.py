"""The L1 ranker (forward) — first rank-and-prune stage (paper §3).

A small MLP over query-document features; its score is the paper's
``g(d)`` inside the reward (Eq. 3) and the ranking function for
candidate pruning.  The parameters are a dict of tensors, as in the
reference.  ``train_l1`` fits them by pointwise regression (AdamW,
torch autograd); the reference's trained parameters can also arrive
through ``repro_torch.weights``.  The matmuls are plain
``torch.matmul`` in float32 (TF32 off, see ``repro_torch.device``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

from .features import FEATURE_DIM, doc_features

__all__ = ["init_l1", "l1_score", "score_all_docs", "train_l1",
           "idf_for_terms"]

Params = Dict[str, torch.Tensor]


def init_l1(generator: torch.Generator, hidden: int = 32,
            feature_dim: int = FEATURE_DIM, device=None) -> Params:
    """Random init from a CPU ``torch.Generator`` (the reference's
    ``jax.random`` draws cannot be reproduced; load those through
    ``repro_torch.weights`` instead).  ``device``: cuda unless asked."""
    device = resolve_device(device)
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


_L1_ADAM = AdamWConfig(lr=3e-3)


def _l1_adam_step(params: Params, opt_state: dict, feats: torch.Tensor,
                  targets: torch.Tensor, weights: torch.Tensor):
    """One AdamW step on the weighted MSE Σw(pred − t)² / max(Σw, 1);
    returns (params, opt_state, loss)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    pred = l1_score(leaves, feats)
    loss = (torch.sum(weights * (pred - targets) ** 2)
            / torch.clamp(weights.sum(), min=1.0))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    params, opt_state = adamw_update(params, dict(zip(leaves, grads)),
                                     opt_state, _L1_ADAM)
    return params, opt_state, loss.detach()


def train_l1(params: Params, feats, gains, weights, steps: int = 300,
             batch: int = 4096, seed: int = 0):
    """Pointwise regression of gain/4 on features (AdamW), on the
    parameters' device.

    feats: (N, FEATURE_DIM), gains: (N,) in [0,4], weights: (N,), numpy
    arrays.  Batch ids come from
    ``np.random.default_rng(seed).integers``, as in the reference, so
    the same inputs give the reference's batches.  Returns (params, the
    per-step losses as Python floats)."""
    dev = next(iter(params.values())).device

    def dev32(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)

    rng = np.random.default_rng(seed)
    targets = dev32(gains) / 4.0
    feats, weights = dev32(feats), dev32(weights)
    opt_state = adamw_init(params)
    n = feats.shape[0]
    losses = []
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, size=min(batch, n))).to(dev)
        params, opt_state, loss = _l1_adam_step(
            params, opt_state, feats[idx], targets[idx], weights[idx])
        losses.append(loss)
    return params, torch.stack(losses).tolist() if losses else []
