"""The port's ``profile`` against orion_kmer_tpu.cli.main: the same JSON
apart from the three wall-time fields, with and without databases and a
sketch, a sample that fails (recorded, and the run goes on), and the
database k-mismatch error."""

import json

import numpy as np
import pytest

from orion_kmer_tpu import codec

from .test_torch_count import _random_fasta, _run_both, port_cpu
from .test_torch_ingest import jax_native_loaded  # noqa: F401  (a fixture)
from .test_torch_joins import _db, _error_of_both, _tiny_batch
from .test_cli_classify import DB1_REF1, DB1_REF2, DB2_REF1
from .util import SAMPLE2_FASTQ, write_file

pytestmark = pytest.mark.usefixtures("jax_native_loaded")

TIME_FIELDS = ("elapsed_seconds", "samples_per_hour")


def _without_times(path):
    doc = json.loads(path.read_text())
    for f in TIME_FIELDS:
        assert isinstance(doc.pop(f), (int, float))
    for p in doc["profiles"]:
        assert isinstance(p.pop("seconds"), float)
    return doc


def _samples(tmp_path):
    s1 = write_file(tmp_path / "s1.fa.gz", _random_fasta(1, 3, 1500) + DB1_REF1 + DB1_REF1)
    s2a = write_file(tmp_path / "s2a.fq", SAMPLE2_FASTQ)
    s2b = write_file(tmp_path / "s2b.fa.zst", DB2_REF1 + _random_fasta(2, 2, 900))
    return [
        {"sample": "S1", "files": [str(s1)]},
        {"sample": "S2", "files": [str(s2a), str(s2b)]},
        {"sample": "broken", "files": [str(tmp_path / "missing.fq")]},
    ]


@pytest.mark.parametrize("scaled", [None, 1, 7])
@pytest.mark.parametrize("with_db", [False, True])
def test_profile_cli_matches_jax(tmp_path, monkeypatch, with_db, scaled):
    _tiny_batch(monkeypatch)
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({"samples": _samples(tmp_path)}))
    extra = ["--scaled", scaled] if scaled else []
    if with_db:
        db1 = _db(tmp_path, "db1.db", 4, [("db1_refA.fa", DB1_REF1), ("db1_refB.fa", DB1_REF2)])
        db2 = _db(tmp_path, "db2.db", 4, [("db2_refC.fa", DB2_REF1)])
        extra += ["-d", db1, db2, "--min-coverage", 0.2]
    a, b = _run_both(tmp_path, lambda d: ["profile", "-k", 4, "--manifest", manifest, "-o", d / "p.json", *extra])
    got = _without_times(b / "p.json")
    assert got == _without_times(a / "p.json")
    assert [p["status"] for p in got["profiles"]] == ["ok", "ok", "error"]
    assert "missing.fq" in got["profiles"][2]["error"]
    assert got["n_ok"] == 2 and got["n_error"] == 1
    assert ("databases_analyzed" in got["profiles"][0]) == with_db
    assert ("sketch" in got["profiles"][0]) == bool(scaled)


def test_profile_counts_and_sketch_against_oracle(tmp_path):
    """One sample of two files at k = 21: totals, uniques, the largest
    multiplicity and the scaled = 3 sketch from the numpy oracle."""
    texts = [_random_fasta(5, 2, 3000), _random_fasta(5, 1, 2000)]
    files = [write_file(tmp_path / f"f{i}.fa", t) for i, t in enumerate(texts)]
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps([{"sample": "S", "files": [str(f) for f in files]}]))
    assert port_cpu(["profile", "-k", 21, "--manifest", manifest, "-o", tmp_path / "p.json", "--scaled", 3]) == 0
    prof = json.loads((tmp_path / "p.json").read_text())["profiles"][0]
    from orion_kmer_tpu.ingest.fastx import parse_fastx_bytes
    from orion_kmer_tpu.ops.sketch import sketch_np

    kmers = np.concatenate([codec.extract_kmers_np(codec.seq_to_codes(r.seq), 21)
                            for t in texts for r in parse_fastx_bytes(t.encode())])
    _, counts = np.unique(kmers, return_counts=True)
    assert prof["total_kmers"] == kmers.shape[0]
    assert prof["unique_kmers"] == counts.shape[0]
    assert prof["max_multiplicity"] == int(counts.max()) > 1
    assert [int(h) for h in prof["sketch"]["hashes"]] == sketch_np(kmers, 3).tolist()


def test_profile_error_paths_match_jax(tmp_path, capsys):
    db3 = _db(tmp_path, "k3.db", 3, [("k3.fa", ">s\nACGTACGTTT\n")])
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps([{"sample": "S", "files": [str(tmp_path / "x.fa")]}]))
    err = _error_of_both(capsys, ["profile", "-k", 4, "--manifest", manifest, "-d", db3, "-o", tmp_path / "o.json"])
    assert "has k=3, profile requested k=4" in err
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"sample": "S"}]))
    assert "Manifest entries need" in _error_of_both(capsys, ["profile", "-k", 4, "--manifest", bad, "-o", tmp_path / "o.json"])
    assert "Failed to load manifest" in _error_of_both(
        capsys, ["profile", "-k", 4, "--manifest", tmp_path / "none.json", "-o", tmp_path / "o.json"]
    )
    assert "Invalid K-mer size" in _error_of_both(capsys, ["profile", "-k", 33, "--manifest", manifest, "-o", tmp_path / "o.json"])
