"""Batches of k - 2, k - 1 and k positions (``ORION_KMER_BATCH``) on every
batching path of the port: every command writes the bytes it writes at
the default batch and the numpy oracle's (``codec.py``), and none hangs.
Below k each path takes a batch of k positions (``host.batch_for``), which
advances one position a cut.

The fixture: ``>a`` / ``ACGTACGTACGTACGTACGTAAAC`` at k = 9, the reads
``r1`` (the same sequence) and ``r2`` (T x 24), and a multi-record FASTQ
with N runs, lowercase bases and reads shorter than k.  Each command runs
in a thread under a 60 s bound, so a hang fails its test and the suite
goes on."""

import json
import threading

import numpy as np
import pytest

from orion_kmer_tpu import codec
from orion_kmer_tpu.db import KmerDb
from orion_kmer_tpu.ingest.fastx import parse_fastx_bytes
from orion_kmer_tpu.ops.hash import splitmix64_np

from .test_torch_count import port_cpu
from .util import write_file

K = 9
BATCHES = [K - 2, K - 1, K]
GENOME = "ACGTACGTACGTACGTACGTAAAC"
TEXTS = {
    "a.fa": f">a\n{GENOME}\n",
    "r.fa": f">r1\n{GENOME}\n>r2\n{'T' * 24}\n",
    "m.fq": "".join(
        f"@m{i} x\n{s}\n+\n{'I' * len(s)}\n"
        for i, s in enumerate([
            "ACGTACGTACGTAAACG", "", "acgtACGTNNacgtacgtacgTTT", "GGGCCCAAATTT" * 3, "ACGTACG",
            "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTT", "CGTACGTAAACGTnACGTACGTACGTACGT", "AC" * 20,
        ])
    ),
}


def run(argv, timeout=60.0):
    """The port's CLI on the CPU in a thread; fails after ``timeout``
    seconds instead of hanging the suite (the thread is left behind)."""
    rc = []
    t = threading.Thread(target=lambda: rc.append(port_cpu([str(a) for a in argv])), daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{argv[0]} did not finish within {timeout} s"
    assert rc == [0]


@pytest.fixture
def files(tmp_path):
    return {name: write_file(tmp_path / name, text) for name, text in TEXTS.items()}


def at_batches(monkeypatch, batch, argv_of):
    """Run argv_of("default") at the default batch, then argv_of("small")
    at ``batch``."""
    monkeypatch.delenv("ORION_KMER_BATCH", raising=False)
    run(argv_of("default"))
    monkeypatch.setenv("ORION_KMER_BATCH", str(batch))
    run(argv_of("small"))


def records(name):
    return list(parse_fastx_bytes(TEXTS[name].encode()))


def kmers(name, normalize=True):
    parts = [codec.extract_kmers_np(codec.seq_to_codes(r.seq, normalize=normalize), K) for r in records(name)]
    return np.concatenate(parts) if parts else np.empty(0, np.uint64)


def oracle_tsv(vals) -> bytes:
    v, c = np.unique(vals, return_counts=True)
    return b"".join(codec.u64_to_seq(int(x), K) + b"\t%d\n" % n for x, n in zip(v.tolist(), c.tolist()))


def oracle_db(names) -> bytes:
    db = KmerDb(k=K)
    for name in names:
        db.add_reference(name, np.unique(kmers(name)))
    return db.to_bincode()


@pytest.mark.parametrize("shards", [None, "3"])
@pytest.mark.parametrize("name", ["a.fa", "m.fq"])
@pytest.mark.parametrize("batch", BATCHES)
def test_count(tmp_path, monkeypatch, files, batch, name, shards):
    if shards:
        monkeypatch.setenv("ORION_KMER_SHARDS", shards)
    at_batches(monkeypatch, batch, lambda tag: ["count", "-k", K, "-i", files[name], "-o", tmp_path / f"{tag}.tsv"])
    got = (tmp_path / "small.tsv").read_bytes()
    assert got == (tmp_path / "default.tsv").read_bytes() == oracle_tsv(kmers(name))
    if name == "a.fa":
        assert len(got) == 60


@pytest.mark.parametrize("batch", BATCHES)
def test_build(tmp_path, monkeypatch, files, batch):
    at_batches(monkeypatch, batch,
               lambda tag: ["build", "-k", K, "-g", files["a.fa"], files["m.fq"], "-o", tmp_path / f"{tag}.db"])
    got = (tmp_path / "small.db").read_bytes()
    assert got == (tmp_path / "default.db").read_bytes() == oracle_db(["a.fa", "m.fq"])


@pytest.mark.parametrize("batch", [5, *BATCHES])
def test_query(tmp_path, monkeypatch, files, batch):
    db = tmp_path / "g.db"
    run(["build", "-k", K, "-g", files["a.fa"], "-o", db])
    vals = np.unique(kmers("a.fa"))
    for name in ("r.fa", "m.fq"):
        at_batches(monkeypatch, batch,
                   lambda tag: ["query", "-d", db, "-r", files[name], "-c", 1, "-o", tmp_path / f"{name}.{tag}"])
        want = b"".join(
            r.id + b"\n" for r in records(name)
            if len(r.seq) >= K
            and np.isin(codec.extract_kmers_np(codec.seq_to_codes(r.seq, normalize=False), K), vals).sum() >= 1
        )
        got = (tmp_path / f"{name}.small").read_bytes()
        assert got == (tmp_path / f"{name}.default").read_bytes() == want
    assert (tmp_path / "r.fa.small").read_bytes() == b"r1\n"


@pytest.mark.parametrize("batch", BATCHES)
def test_classify(tmp_path, monkeypatch, files, batch):
    db = tmp_path / "g.db"
    run(["build", "-k", K, "-g", files["a.fa"], files["r.fa"], "-o", db])
    at_batches(monkeypatch, batch, lambda tag: ["classify", "-i", files["m.fq"], "-d", db, "--min-kmer-frequency", 1,
                                                "-o", tmp_path / f"{tag}.json", "--output-tsv", tmp_path / f"{tag}.tsv"])
    for ext in ("json", "tsv"):
        assert (tmp_path / f"small.{ext}").read_bytes() == (tmp_path / f"default.{ext}").read_bytes()
    doc = json.loads((tmp_path / "small.json").read_text())
    inputs = np.unique(kmers("m.fq"))
    assert doc["total_unique_kmers_in_input"] == inputs.shape[0]
    refs = doc["databases_analyzed"][0]["references"]
    assert [r["reference_name"] for r in refs] == ["a.fa", "r.fa"]
    for r in refs:
        assert r["input_kmers_hitting_reference"] == int(np.isin(inputs, np.unique(kmers(r["reference_name"]))).sum())
    assert refs[0]["input_kmers_hitting_reference"] > 0


@pytest.mark.parametrize("batch", BATCHES)
def test_sketch(tmp_path, monkeypatch, files, batch):
    at_batches(monkeypatch, batch, lambda tag: ["sketch", "-k", K, "--scaled", 1, "-i", files["a.fa"], files["m.fq"],
                                                "-o", tmp_path / f"{tag}.sig"])
    assert (tmp_path / "small.sig").read_bytes() == (tmp_path / "default.sig").read_bytes()
    sketches = json.loads((tmp_path / "small.sig").read_text())["sketches"]
    for sk, name in zip(sketches, ("a.fa", "m.fq")):
        h, n = np.unique(splitmix64_np(kmers(name)), return_counts=True)  # scaled 1 keeps every hash
        assert [int(x) for x in sk["hashes"]] == h.tolist()
        assert sk["abundances"] == n.tolist()


@pytest.mark.parametrize("batch", BATCHES)
def test_profile(tmp_path, monkeypatch, files, batch):
    db = tmp_path / "g.db"
    run(["build", "-k", K, "-g", files["a.fa"], "-o", db])
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps([{"sample": "S", "files": [str(files["m.fq"]), str(files["r.fa"])]}]))
    at_batches(monkeypatch, batch, lambda tag: ["profile", "-k", K, "--manifest", manifest, "-d", db, "--scaled", 1,
                                                "-o", tmp_path / f"{tag}.json"])

    def without_times(path):
        doc = json.loads(path.read_text())
        del doc["elapsed_seconds"], doc["samples_per_hour"]
        for p in doc["profiles"]:
            del p["seconds"]
        return doc

    got = without_times(tmp_path / "small.json")
    assert got == without_times(tmp_path / "default.json")
    prof = got["profiles"][0]
    v, c = np.unique(np.concatenate([kmers("m.fq"), kmers("r.fa")]), return_counts=True)
    assert (prof["total_kmers"], prof["unique_kmers"], prof["max_multiplicity"]) == (int(c.sum()), v.shape[0], int(c.max()))
    assert [int(x) for x in prof["sketch"]["hashes"]] == np.sort(splitmix64_np(v)).tolist()
