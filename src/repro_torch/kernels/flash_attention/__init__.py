"""Flash attention: CUDA kernel wrapper and plain torch version."""
from .ops import (FLASH_ATTENTION_KERNEL, FLASH_ATTENTION_TC_KERNEL, MAX_BLOCK,
                  MAX_HEAD_DIM, TC_HEAD_DIMS, flash_attention,
                  tensor_core_route)
from .ref import attention_ref

__all__ = ["FLASH_ATTENTION_KERNEL", "FLASH_ATTENTION_TC_KERNEL", "MAX_BLOCK",
           "MAX_HEAD_DIM", "TC_HEAD_DIMS", "attention_ref", "flash_attention",
           "tensor_core_route"]
