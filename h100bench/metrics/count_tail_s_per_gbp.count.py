"""The tail of ``count`` inside the measured calls (the port's
``count.tail`` spans: the -m filter, the histogram and the TSV into the
drained pipe) in the traced window: seconds a call, per Gbp of reads."""

from h100bench.harness import spans
from h100bench.harness.readers import gbp


def read(ctx):
    s = spans.seconds_a_call(ctx, "count.tail")
    return None if s is None else s / gbp(ctx)
