"""The program's count of collectives (``collectives()``) over the
span-traced calls, per call, on rank 0 (the four-slice serve cell)."""


def read(ctx):
    if getattr(ctx, "kind", None) != "serve_x4" \
            or ctx.collectives_traced is None or not ctx.spanned_calls:
        return None
    return ctx.collectives_traced / ctx.spanned_calls
