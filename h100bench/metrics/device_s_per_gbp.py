"""The card's busy time a call, per Gbp of the call's input: the union of
every kernel, copy and memset interval over the window (the profiler's
timeline), over the calls completed and the input's bases."""

from h100bench.harness.readers import gbp


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.window.calls:
        return None
    return ctx.trace.busy_s / ctx.window.calls / gbp(ctx)
