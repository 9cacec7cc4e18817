"""The card's idle time while the consumer waits for the next staged
batch: the gaps in the union of kernel, copy and memset intervals inside
the ``h100bench.call`` ranges during which the port's ``engine.wait`` was
the innermost span open on the CLI's thread; seconds a call, per Gbp of
reads."""

from h100bench.harness import spans
from h100bench.harness.readers import gbp


def read(ctx):
    s = spans.idle_s_a_call(ctx, "engine.wait")
    return None if s is None else s / gbp(ctx)
