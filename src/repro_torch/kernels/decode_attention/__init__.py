"""Decode attention: CUDA kernel wrapper and plain torch version."""
from .ops import (BLOCK_K, DECODE_ATTENTION_KERNEL, MAX_GROUP, MAX_HEAD_DIM,
                  decode_attention, merge_partials, split_plan)
from .ref import decode_attention_ref, merge_partials_ref

__all__ = ["BLOCK_K", "DECODE_ATTENTION_KERNEL", "MAX_GROUP", "MAX_HEAD_DIM",
           "decode_attention", "decode_attention_ref", "merge_partials",
           "merge_partials_ref", "split_plan"]
