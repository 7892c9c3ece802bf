"""bert4rec [arXiv:1904.06690; paper] — bidirectional self-attention
over item sequences: embed_dim=64, 2 blocks, 2 heads, seq_len=200,
masked-item training, tied-weight item scoring.  Item vocab 1M
(huge_embedding regime); retrieval_cand dots the encoded user state
against the item table."""
from __future__ import annotations

from repro_torch.models.recsys import B4RConfig
from .base import ArchDef, register
from .recsys_family import recsys_shapes


def model_cfg(reduced: bool) -> B4RConfig:
    if reduced:
        return B4RConfig(n_items=512, embed_dim=32, n_blocks=2, n_heads=2, seq_len=32)
    return B4RConfig(n_items=1_000_000, embed_dim=64, n_blocks=2, n_heads=2, seq_len=200)


ARCH = register(ArchDef(
    arch_id="bert4rec", family="recsys",
    source="[arXiv:1904.06690; paper]",
    model_cfg=model_cfg, shapes=recsys_shapes(),
))
