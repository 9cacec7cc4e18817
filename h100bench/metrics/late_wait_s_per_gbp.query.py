"""The CLI thread's wait for a query batch's hits, fetched one batch late
(the port's ``query.late_wait`` spans: ``_LateHits.flush``'s wait on the
batch's copy event) in the traced window: seconds a call, per Gbp of
reads.  The CPU keeps no event, so it reads 0 there."""

from h100bench.harness import spans
from h100bench.harness.readers import gbp


def read(ctx):
    s = spans.seconds_a_call(ctx, "query.late_wait")
    return None if s is None else s / gbp(ctx)
