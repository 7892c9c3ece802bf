"""The block scans: CUDA kernel wrappers, rule lists and meta, the
public entry points (``ops``) and the plain torch versions."""
from .block_scan import BLOCK_SCAN_TILE_KERNEL
from .block_scan_pruned import (BLOCK_SCAN_KERNEL, BLOCK_SCAN_STATIC_KERNEL,
                                META_BP_COL, META_ROWS,
                                block_scan_pruned_chunk,
                                build_rule_meta, static_plane_list)
from .ops import (block_scan, block_scan_batched, block_scan_pruned,
                  block_scan_reference)
from .ref import block_scan_pruned_chunk_ref, block_scan_pruned_ref

__all__ = ["BLOCK_SCAN_KERNEL", "BLOCK_SCAN_STATIC_KERNEL",
           "BLOCK_SCAN_TILE_KERNEL", "META_BP_COL", "META_ROWS", "block_scan",
           "block_scan_batched", "block_scan_pruned",
           "block_scan_pruned_chunk", "block_scan_pruned_chunk_ref",
           "block_scan_pruned_ref", "block_scan_reference", "build_rule_meta",
           "static_plane_list"]
