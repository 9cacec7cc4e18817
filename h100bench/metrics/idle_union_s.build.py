"""The card's idle time during the union of the database's sets: the
gaps in the union of kernel, copy and memset intervals inside the
``h100bench.call`` ranges during which the port's ``db.union`` was the
innermost span open on the CLI's thread; seconds a call."""

from h100bench.harness import spans


def read(ctx):
    return spans.idle_s_a_call(ctx, "db.union")
