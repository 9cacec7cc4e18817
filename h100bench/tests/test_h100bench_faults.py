"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; so does the control, the reference with
one stated guarantee broken put in the program's place.  The cells are
those of ``BENCHMARK.json``; the faults are planted in the port on the CPU
by the file of the cell's command (``tests/faults/<command>.py``), at the
configuration's tiny size; the cells run on one card, so no exchange
between cards can be left out."""

import pytest

from h100bench.harness.manifest import Manifest
from h100bench.tests.helpers import FAULTS, ROOT, cells, faults, run_tiny, tiny_config


@pytest.mark.parametrize("cell", cells())
def test_a_sound_run_is_correct(cell):
    r = run_tiny(cell)
    assert r["correct"] is True, r
    assert list(r)[-1] == "checks" and all(c["value"] == 0 for c in r["checks"].values())


def test_a_traced_run_is_correct_and_reads_its_layers():
    r = run_tiny("count-k31", trace=True)
    assert r["correct"] is True
    assert {"parse_mbp_per_s.count", "engine_s_per_gbp.count", "tail_s_per_gbp.count"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", cells())
def test_a_fault_makes_the_run_not_correct(monkeypatch, cell, fault):
    """A cell whose command has no faults file fails here: loading it
    raises."""
    man = Manifest(ROOT)
    command = man.traffic(man.workload(cell)["traffic"])["command"]
    getattr(faults(man, command), fault)(monkeypatch)
    r = run_tiny(cell)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", cells())
def test_the_control_is_not_correct(monkeypatch, cell):
    """The reference with a stated guarantee broken (count and build: k-mers
    keyed by a 40-bit hash; query: hits from a 1-in-10 sample of windows)
    in the program's place.  At the tiny size a 40-bit key merges nothing,
    so the count and build controls narrow to 16 bits here."""
    from h100bench.control import control_checks
    from h100bench.reference import kmers

    narrowed = kmers.narrowed
    monkeypatch.setattr(kmers, "narrowed", lambda v, c, bits=40: narrowed(v, c, 16))
    r = control_checks(cell, 2**31 + 3, device="cpu", config_override=tiny_config(Manifest(ROOT), cell))
    assert r["correct"] is False, r["checks"]
