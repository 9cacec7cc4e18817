"""The union of the database's sets inside the measured calls (the port's
``db.union`` spans, ``KmerDb.get_all_kmers_unified``) in the traced
window: seconds a call."""

from h100bench.harness import spans


def read(ctx):
    return spans.seconds_a_call(ctx, "db.union")
