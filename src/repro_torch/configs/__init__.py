"""Arch registry: importing this package registers every config of the
reference (the paper's websearch-rl system, the five LMs, the GNN and
the recsys models)."""
from .base import ArchDef, ShapeSpec, get_arch, list_archs

__all__ = ["ArchDef", "ShapeSpec", "get_arch", "list_archs"]

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        mistral_nemo_12b,
        starcoder2_3b,
        phi4_mini_3_8b,
        deepseek_v2_lite_16b,
        grok1_314b,
        graphsage_reddit,
        wide_deep,
        deepfm,
        dcn_v2,
        bert4rec,
        websearch_rl,
    )
