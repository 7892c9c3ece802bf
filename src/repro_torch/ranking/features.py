"""Query-document features for the L1 ranker, batched over queries.

Computed from the bitpacked occupancy tensor (exactly the evidence the
match engine sees) plus per-document side data (static rank, field
lengths) and per-query term IDFs.
"""
from __future__ import annotations

import torch

from repro_torch.index.blocks import unpack_words
from repro_torch.index.corpus import N_FIELDS

__all__ = ["FEATURE_DIM", "unpack_occupancy", "doc_features"]

FEATURE_DIM = 3 * N_FIELDS + 3  # 15 for 4 fields


def unpack_occupancy(occ: torch.Tensor) -> torch.Tensor:
    """(Q, n_blocks, T, F, W) int32 -> (Q, n_docs_padded, T, F) bool."""
    q, nb, t, f, _ = occ.shape
    bits = unpack_words(occ)                                  # (Q, nb, T, F, D)
    return bits.permute(0, 1, 4, 2, 3).reshape(q, -1, t, f)


def doc_features(
    occ: torch.Tensor,          # (Q, n_blocks, T, F, W) int32
    idf: torch.Tensor,          # (Q, T) float32 (0 for padded slots)
    term_present: torch.Tensor, # (Q, T) bool
    static_rank: torch.Tensor,  # (n_docs_padded,) float32
    doc_len: torch.Tensor,      # (n_docs_padded, F) float32
) -> torch.Tensor:
    """Per-document features, (Q, n_docs_padded, FEATURE_DIM) float32."""
    tp = term_present.to(torch.float32)                       # (Q, T)
    hits = unpack_occupancy(occ).to(torch.float32) * tp[:, None, :, None]
    nt = torch.clamp(tp.sum(dim=1), min=1.0)[:, None]         # (Q, 1)

    field_cov = hits.sum(dim=2) / nt[..., None]                       # (Q, D, F)
    idf_sum = torch.clamp((idf * tp).sum(dim=1), min=1e-6)[:, None, None]
    field_idf = (hits * idf[:, None, :, None]).sum(dim=2) / idf_sum   # (Q, D, F)
    any_field = hits.amax(dim=3)                                      # (Q, D, T)
    n_matched = any_field.sum(dim=2)                                  # (Q, D)
    terms_matched = n_matched / nt
    all_matched = (n_matched >= nt).to(torch.float32)
    q, d = hits.shape[:2]
    return torch.cat([
        field_cov,
        field_idf,
        terms_matched[..., None],
        all_matched[..., None],
        static_rank.expand(q, d)[..., None],
        doc_len.expand(q, d, doc_len.shape[1]),
    ], dim=2)
