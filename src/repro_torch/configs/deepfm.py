"""deepfm [arXiv:1703.04247; paper] — 39 sparse fields, embed_dim=10,
MLP 400-400-400, FM interaction (first order + pairwise via the
(Σv)²−Σv² identity) sharing embeddings with the deep tower."""
from __future__ import annotations

from repro_torch.models.recsys import RecsysConfig
from .base import ArchDef, register
from .recsys_family import recsys_shapes


def model_cfg(reduced: bool) -> RecsysConfig:
    if reduced:
        return RecsysConfig(n_sparse=6, vocab_per_field=64, embed_dim=8,
                            mlp_dims=(32, 16), interaction="fm")
    return RecsysConfig(n_sparse=39, vocab_per_field=1_000_000, embed_dim=10,
                        mlp_dims=(400, 400, 400), interaction="fm")


ARCH = register(ArchDef(
    arch_id="deepfm", family="recsys",
    source="[arXiv:1703.04247; paper]",
    model_cfg=model_cfg, shapes=recsys_shapes(),
))
