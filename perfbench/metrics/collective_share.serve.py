"""100 x the union of the NCCL kernels' intervals on card 0 over the
traced slice's wall time (the four-slice serve cell): the collectives
and the wait inside them for the slowest slice."""


def read(ctx):
    if getattr(ctx, "kind", None) != "serve_x4" or ctx.trace is None \
            or ctx.collective_busy_s is None:
        return None
    return 100.0 * ctx.collective_busy_s / ctx.trace.window_s
