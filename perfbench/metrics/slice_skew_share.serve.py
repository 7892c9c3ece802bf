"""The median over the unprofiled span-traced calls of the spread of the
ranks' ``rollout`` span durations over the call's wall time, in % (the
four-slice serve cell): how long the row waits for its slowest slice's
rules, apart from when each rank started the call."""
import statistics


def read(ctx):
    if getattr(ctx, "kind", None) != "serve_x4" or not ctx.skew_shares:
        return None
    return statistics.median(ctx.skew_shares)
