"""The host CPU time a call, per Gbp of the call's input: the process's
user and system seconds over the window, all threads, over the calls
completed and the input's bases."""

from h100bench.harness.readers import gbp


def read(ctx):
    if not ctx.window.calls or ctx.window.cpu_s <= 0:
        return None
    return ctx.window.cpu_s / ctx.window.calls / gbp(ctx)
