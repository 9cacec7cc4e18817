"""The host stage's pack into the pinned ring (the port's
``ingest.stage`` spans on the prefetch thread: each batch packed into
its slot, with the wait for the slot's last copy, and its copies
started) in the traced window: seconds a call, per Gbp of reads."""

from h100bench.harness import spans
from h100bench.harness.readers import gbp


def read(ctx):
    s = spans.seconds_a_call(ctx, "ingest.stage")
    return None if s is None else s / gbp(ctx)
