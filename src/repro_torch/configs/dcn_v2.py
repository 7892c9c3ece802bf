"""dcn-v2 [arXiv:2008.13535; paper] — 13 dense + 26 sparse fields,
embed_dim=16, 3 full-rank cross layers, parallel deep tower
1024-1024-512."""
from __future__ import annotations

from repro_torch.models.recsys import RecsysConfig
from .base import ArchDef, register
from .recsys_family import recsys_shapes


def model_cfg(reduced: bool) -> RecsysConfig:
    if reduced:
        return RecsysConfig(n_sparse=6, vocab_per_field=64, embed_dim=8,
                            mlp_dims=(32, 16), n_dense=4, n_cross_layers=2,
                            interaction="cross")
    return RecsysConfig(n_sparse=26, vocab_per_field=1_000_000, embed_dim=16,
                        mlp_dims=(1024, 1024, 512), n_dense=13,
                        n_cross_layers=3, interaction="cross")


ARCH = register(ArchDef(
    arch_id="dcn-v2", family="recsys",
    source="[arXiv:2008.13535; paper]",
    model_cfg=model_cfg, shapes=recsys_shapes(),
))
