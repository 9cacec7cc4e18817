"""Launches of K1-K4 in the traced window, from the port's counters
(``ops/{extract,merge,compact,sort}.launches``), per call and Gbp."""

from h100bench.harness.readers import gbp


def read(ctx):
    n = sum(ctx.counters_after[k] - ctx.counters_before[k] for k in ctx.counters_after)
    if not n:  # the CPU path launches no kernel
        return None
    return n / ctx.window.calls / gbp(ctx)
