"""EmbeddingBag: CUDA kernel wrapper and plain torch version."""
from .ops import EMBEDDING_BAG_KERNEL, embedding_bag, embedding_bag_kernel
from .ref import embedding_bag_ref

__all__ = ["EMBEDDING_BAG_KERNEL", "embedding_bag", "embedding_bag_kernel",
           "embedding_bag_ref"]
