"""The prefetch thread's wait for the parser threads (the self time of
the port's ``ingest.parse`` spans: each ``next()`` on the parsed,
re-batched stream) in the traced window, per Gbp of the stream positions
those spans counted: the bases and the k-1 invalid positions between
records, ~1.2 G a call of 150 bp reads at k = 31.  Not the parse's own
work: the parser threads run ahead while the prefetch thread packs."""

from h100bench.harness import spans


def read(ctx):
    view = spans.of(ctx)
    n = None if view is None else view.count("positions", "ingest.parse")
    if not n:
        return None
    return view.self_s("ingest.parse") / (n / 1e9)
