"""The faults planted under ``query``: the late hits (``_LateHits.push``),
a batch's join (``_batch_hits``) and the hits stream (``_query_stream``)."""

from orion_kmer_tpu_torch import engine


def unchanged(monkeypatch):
    """A step that returns its state unchanged: no batch's hits reach the
    reads."""
    monkeypatch.setattr(engine._LateHits, "push", lambda self, first_rid, hits: None)


def half_batch(monkeypatch):
    """Half of every batch left out: only its first half of positions is
    joined."""
    hits = engine._batch_hits
    monkeypatch.setattr(engine, "_batch_hits",
                        lambda lanes, inv, size, n, starts, db, k: hits(lanes, inv, size, n // 2, starts, db, k))


def altered(monkeypatch):
    """One answer altered where it is produced: a read's hits."""
    stream = engine._query_stream

    def altered_stream(*a, **kw):
        blob, id_ends, lens, hits = stream(*a, **kw)
        hits = hits.copy()
        hits[0] = 0
        return blob, id_ends, lens, hits

    monkeypatch.setattr(engine, "_query_stream", altered_stream)
