"""wide-deep [arXiv:1606.07792; paper] — 40 sparse fields, embed_dim=32,
MLP 1024-512-256, wide linear + deep concat interaction.  Tables are
40 × 1M rows (huge_embedding regime)."""
from __future__ import annotations

from repro_torch.models.recsys import RecsysConfig
from .base import ArchDef, register
from .recsys_family import recsys_shapes


def model_cfg(reduced: bool) -> RecsysConfig:
    if reduced:
        return RecsysConfig(n_sparse=6, vocab_per_field=64, embed_dim=8,
                            mlp_dims=(32, 16), interaction="concat")
    return RecsysConfig(n_sparse=40, vocab_per_field=1_000_000, embed_dim=32,
                        mlp_dims=(1024, 512, 256), interaction="concat")


ARCH = register(ArchDef(
    arch_id="wide-deep", family="recsys",
    source="[arXiv:1606.07792; paper]",
    model_cfg=model_cfg, shapes=recsys_shapes(),
))
