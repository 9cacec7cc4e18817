"""The consumer's waits for the next staged batch (the port's
``engine.wait`` spans, on the prefetch queue) in the traced window:
seconds a call, per Gbp of reads."""

from h100bench.harness import spans
from h100bench.harness.readers import gbp


def read(ctx):
    s = spans.seconds_a_call(ctx, "engine.wait")
    return None if s is None else s / gbp(ctx)
