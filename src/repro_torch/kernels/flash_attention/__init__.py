"""Flash attention: CUDA kernel wrapper and plain torch version."""
from .ops import FLASH_ATTENTION_KERNEL, MAX_BLOCK, MAX_HEAD_DIM, flash_attention
from .ref import attention_ref

__all__ = ["FLASH_ATTENTION_KERNEL", "MAX_BLOCK", "MAX_HEAD_DIM",
           "attention_ref", "flash_attention"]
