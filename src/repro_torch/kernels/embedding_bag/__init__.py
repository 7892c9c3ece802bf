"""EmbeddingBag: CUDA kernel wrappers and plain torch version."""
from .ops import (EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL, bag_route,
                  embedding_bag, embedding_bag_kernel)
from .ref import embedding_bag_ref

__all__ = ["EMBEDDING_BAG_KERNEL", "EMBEDDING_BAG_LANES_KERNEL", "bag_route",
           "embedding_bag", "embedding_bag_kernel", "embedding_bag_ref"]
