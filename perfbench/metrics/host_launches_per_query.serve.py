"""Kernel-launch API calls of the traced slice per query (serve cells)."""
from perfbench.readers import launches_per_query


def read(ctx):
    return launches_per_query(ctx, "serve")
