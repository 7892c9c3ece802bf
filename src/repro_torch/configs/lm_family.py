"""Shared shape set + builder for the 5 LM-family transformer archs."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.attention import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig
from .base import ArchDef, ShapeSpec, register

__all__ = ["lm_shapes", "make_lm_arch"]


def lm_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec("train_4k", "train",
                              dict(seq_len=4096, global_batch=256)),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 dict(seq_len=32768, global_batch=32)),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                dict(seq_len=32768, global_batch=128)),
        "long_500k": ShapeSpec(
            "long_500k", "decode", dict(seq_len=524288, global_batch=1),
            note="decode-only: KV sequence-sharded over `model` + LSE merge; "
                 "500K PREFILL would be quadratic for these full-attention "
                 "archs and is skipped (DESIGN.md §6).",
        ),
    }


def make_lm_arch(
    arch_id: str,
    source: str,
    *,
    n_layers: int,
    d_model: int,
    n_heads: int,
    n_kv: int,
    d_ff: int,
    vocab: int,
    d_head: Optional[int] = None,
    mlp_kind: str = "swiglu",
    moe: Optional[dict] = None,          # dict(n_experts, top_k, n_shared, d_ff)
    mla: Optional[dict] = None,          # dict(kv_lora_rank, d_nope, d_rope, d_v)
    rope_theta: float = 1e6,
    fsdp: bool = False,
    notes: str = "",
) -> ArchDef:
    d_head = d_head or d_model // n_heads

    def model_cfg(reduced: bool) -> TransformerConfig:
        if reduced:
            moe_cfg = (
                MoEConfig(n_experts=4, top_k=min(2, moe["top_k"]), d_model=128,
                          d_ff=128, n_shared=min(1, moe.get("n_shared", 0)))
                if moe else None
            )
            mla_cfg = (
                MLAConfig(d_model=128, n_heads=4, kv_lora_rank=32, d_nope=16,
                          d_rope=8, d_v=16, q_chunk=64)
                if mla else None
            )
            return TransformerConfig(
                n_layers=2, d_model=128, n_heads=4, n_kv=(2 if n_kv < n_heads else 4),
                d_head=32, d_ff=256, vocab=512,
                mlp_kind=mlp_kind, attn_kind="mla" if mla else "gqa",
                moe=moe_cfg, mla=mla_cfg, max_seq=128, q_chunk=64, loss_chunk=128,
                remat=False, param_dtype=torch.float32,
            )
        moe_cfg = (
            MoEConfig(n_experts=moe["n_experts"], top_k=moe["top_k"],
                      d_model=d_model, d_ff=moe["d_ff"],
                      n_shared=moe.get("n_shared", 0))
            if moe else None
        )
        mla_cfg = (
            MLAConfig(d_model=d_model, n_heads=n_heads,
                      kv_lora_rank=mla["kv_lora_rank"], d_nope=mla["d_nope"],
                      d_rope=mla["d_rope"], d_v=mla["d_v"], q_chunk=512)
            if mla else None
        )
        return TransformerConfig(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv=n_kv,
            d_head=d_head, d_ff=d_ff, vocab=vocab, mlp_kind=mlp_kind,
            attn_kind="mla" if mla else "gqa", moe=moe_cfg, mla=mla_cfg,
            rope_theta=rope_theta, max_seq=4096, q_chunk=512, loss_chunk=4096,
            remat=True, param_dtype=torch.bfloat16, sp_carry=True, microbatch=4,
            fsdp=fsdp, grad_accum_dtype=torch.bfloat16 if fsdp else torch.float32,
        )

    return register(ArchDef(
        arch_id=arch_id, family="lm", source=source,
        model_cfg=model_cfg, shapes=lm_shapes(), notes=notes,
    ))
