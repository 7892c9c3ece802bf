"""The device's idle share of the traced slice (learn cells)."""
from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "learn")
