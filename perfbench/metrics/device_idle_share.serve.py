"""The device's idle share of the traced slice (serve cells)."""
from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "serve")
