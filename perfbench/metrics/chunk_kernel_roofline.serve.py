"""The chunk block-scan kernel's share of the memory roofline on the
plane-blocks that u counts (serve cells)."""
from perfbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "serve", "block_scan_pruned_chunk")
