"""EmbeddingBag: CUDA kernel wrappers, plain torch version, and the
fixed-order gradients of the bag and of a row gather."""
from .backward import embedding_bag_backward, scatter_rows, take_rows
from .ops import (EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL, bag_route,
                  embedding_bag, embedding_bag_kernel)
from .ref import embedding_bag_ref

__all__ = ["EMBEDDING_BAG_KERNEL", "EMBEDDING_BAG_LANES_KERNEL", "bag_route",
           "embedding_bag", "embedding_bag_backward", "embedding_bag_kernel",
           "embedding_bag_ref", "scatter_rows", "take_rows"]
