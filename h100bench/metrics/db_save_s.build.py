"""The database's write inside the measured calls (the port's ``db.save``
spans: the bincode built and written into the drained pipe) in the
traced window: seconds a call."""

from h100bench.harness import spans


def read(ctx):
    return spans.seconds_a_call(ctx, "db.save")
