"""The whole call's share of the memory roofline (learn cells)."""
from perfbench.readers import step_roofline


def read(ctx):
    return step_roofline(ctx, "learn")
