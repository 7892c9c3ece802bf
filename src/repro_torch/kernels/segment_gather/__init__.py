"""Segment gather-sum: the CUDA kernel's wrapper, its CSR, the mean and
sum aggregations with their gradients, and the plain torch version."""
from .ops import (SEGMENT_GATHER_KERNEL, SegmentCSR, segment_gather_sum,
                  segment_mean, segment_sum)
from .ref import segment_gather_sum_ref

__all__ = ["SEGMENT_GATHER_KERNEL", "SegmentCSR", "segment_gather_sum",
           "segment_gather_sum_ref", "segment_mean", "segment_sum"]
