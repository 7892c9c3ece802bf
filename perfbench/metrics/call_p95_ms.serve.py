"""The 95th percentile of a call's host-clock time (serve cells whose
runs spread too widely to bound ``serve_p95_ms``)."""
from perfbench.readers import call_p95_ms


def read(ctx):
    return call_p95_ms(ctx, "serve")
