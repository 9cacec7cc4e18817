"""The count table's copy to the host in the traced window: the bytes of
its two planes as the port counts them (the ``engine.fetch`` spans'
``bytes``, 16 B a key) over the card's copies from device to pinned
memory (the fetch's alone on the count path), GB/s."""

from h100bench.harness import spans


def read(ctx):
    view = spans.of(ctx)
    if view is None:
        return None
    n_bytes = view.count("bytes", "engine.fetch")
    copies = [e - s for s, e, n in ctx.trace.device if n.startswith("Memcpy DtoH") and "Pinned" in n]
    if not n_bytes or not copies:
        return None
    return n_bytes / sum(copies) / 1e9
