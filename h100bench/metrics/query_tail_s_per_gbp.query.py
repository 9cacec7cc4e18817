"""The tail of ``query`` inside the measured calls (the port's
``query.tail`` spans: the passing reads' ids gathered, then written into
the drained pipe) in the traced window: seconds a call, per Gbp of
reads."""

from h100bench.harness import spans
from h100bench.harness.readers import gbp


def read(ctx):
    s = spans.seconds_a_call(ctx, "query.tail")
    return None if s is None else s / gbp(ctx)
