"""The whole call's share of the row's memory roofline (the four-slice
serve cell): the compulsory bytes of the merged answer (u summed over
the slices) over (the mean untraced call time x the cards x the
published bandwidth)."""


def read(ctx):
    if getattr(ctx, "kind", None) != "serve_x4" or not ctx.hbm_bytes_per_s \
            or not ctx.mean_call_s:
        return None
    return 100.0 * ctx.step_bytes / (ctx.mean_call_s * ctx.cards
                                     * ctx.hbm_bytes_per_s)
