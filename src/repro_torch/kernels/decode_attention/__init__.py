"""Decode attention: CUDA kernel wrappers and plain torch version."""
from .ops import (BLOCK_K, DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL,
                  MAX_GROUP, MAX_HEAD_DIM, TC_BLOCK_K, TC_HEAD_DIMS,
                  decode_attention, merge_partials, split_plan, split_plan_tc,
                  tensor_core_route)
from .ref import decode_attention_ref, merge_partials_ref

__all__ = ["BLOCK_K", "DECODE_ATTENTION_KERNEL", "DECODE_ATTENTION_TC_KERNEL",
           "MAX_GROUP", "MAX_HEAD_DIM", "TC_BLOCK_K", "TC_HEAD_DIMS",
           "decode_attention", "decode_attention_ref", "merge_partials",
           "merge_partials_ref", "split_plan", "split_plan_tc",
           "tensor_core_route"]
