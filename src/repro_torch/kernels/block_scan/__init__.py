"""The plane-pruned chunked block scan: CUDA kernel wrapper, rule meta
and plain torch version."""
from .block_scan_pruned import (BLOCK_SCAN_KERNEL, META_ROWS,
                                block_scan_pruned_chunk, build_rule_meta)
from .ref import block_scan_pruned_chunk_ref

__all__ = ["BLOCK_SCAN_KERNEL", "META_ROWS", "block_scan_pruned_chunk",
           "block_scan_pruned_chunk_ref", "build_rule_meta"]
