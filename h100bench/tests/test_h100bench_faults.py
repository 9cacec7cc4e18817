"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; so does the control, the reference with
one stated guarantee broken put in the program's place.  The faults are
planted in the port on the CPU, at a tiny size; the cells run on one
card, so no exchange between cards can be left out."""

import pytest

from h100bench.harness.manifest import Manifest
from h100bench.tests.helpers import root_for, run_tiny, tiny_config

# the cells of BENCHMARK.json, then those put off
CELLS = ["count-k31", "build-k31", "count-k21", "query-c10"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = run_tiny(cell)
    assert r["correct"] is True, r
    assert list(r)[-1] == "checks" and all(c["value"] == 0 for c in r["checks"].values())


def test_a_traced_run_is_correct_and_reads_its_layers():
    r = run_tiny("count-k31", trace=True)
    assert r["correct"] is True
    assert {"parse_mbp_per_s.count", "engine_s_per_gbp.count", "tail_s_per_gbp.count"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: no batch reaches the
    table (count, build), no batch's hits reach the reads (query)."""
    from orion_kmer_tpu_torch import engine

    monkeypatch.setattr(engine.DeviceCountTable, "update_packed", lambda self, *a: None)
    monkeypatch.setattr(engine._LateHits, "push", lambda self, first_rid, hits: None)


def _half_batch(monkeypatch):
    """Half of every batch left out: only its first half of positions is
    counted or joined."""
    from orion_kmer_tpu_torch import engine

    update = engine.DeviceCountTable.update_packed
    monkeypatch.setattr(engine.DeviceCountTable, "update_packed",
                        lambda self, lanes, inv, size, n: update(self, lanes, inv, size, n // 2))
    hits = engine._batch_hits
    monkeypatch.setattr(engine, "_batch_hits",
                        lambda lanes, inv, size, n, starts, db, k: hits(lanes, inv, size, n // 2, starts, db, k))


def _altered(monkeypatch):
    """One answer altered where it is produced: a count, a database's
    k-mer, a read's hits."""
    from orion_kmer_tpu_torch import engine

    count_file = engine.count_file

    def altered_count(*a, **kw):
        vals, counts = count_file(*a, **kw)
        counts = counts.copy()
        counts[len(counts) // 2] += 1
        return vals, counts

    def altered_set(*a, **kw):
        vals, counts = count_file(*a, **kw)
        return vals[:-1], counts[:-1]

    monkeypatch.setattr("orion_kmer_tpu_torch.commands.count.count_file", altered_count)
    monkeypatch.setattr("orion_kmer_tpu_torch.commands.build.count_file", altered_set)
    stream = engine._query_stream

    def altered_stream(*a, **kw):
        blob, id_ends, lens, hits = stream(*a, **kw)
        hits = hits.copy()
        hits[0] = 0
        return blob, id_ends, lens, hits

    monkeypatch.setattr(engine, "_query_stream", altered_stream)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_makes_the_run_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run_tiny(cell)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(monkeypatch, cell):
    """The reference with a stated guarantee broken (count and build: k-mers
    keyed by a 40-bit hash; query: hits from a 1-in-10 sample of windows)
    in the program's place.  At the tiny size a 40-bit key merges nothing,
    so the count and build controls narrow to 16 bits here."""
    from h100bench.control import control_checks
    from h100bench.reference import kmers

    narrowed = kmers.narrowed
    monkeypatch.setattr(kmers, "narrowed", lambda v, c, bits=40: narrowed(v, c, 16))
    root = root_for(cell)
    r = control_checks(cell, 2**31 + 3, device="cpu", config_override=tiny_config(Manifest(root), cell),
                       root=root)
    assert r["correct"] is False, r["checks"]
