"""``engine.count_file`` inside the measured calls (the port's
``engine.count_file`` spans: the count table's staging, updates, flush
and fetch) in the traced window: seconds a call, per Gbp of reads."""

from h100bench.harness import spans
from h100bench.harness.readers import gbp


def read(ctx):
    s = spans.seconds_a_call(ctx, "engine.count_file")
    return None if s is None else s / gbp(ctx)
