"""The whole call's share of the memory roofline (serve cells)."""
from perfbench.readers import step_roofline


def read(ctx):
    return step_roofline(ctx, "serve")
