"""The port's set-join slice as a whole: its ``compare``, ``query`` and
``classify`` against orion_kmer_tpu.cli.main, byte for byte, on the
fixtures of the JAX package's CLI suites, its fuzz seeds and its
size seams.  Databases are built once, by the JAX CLI, and shared, so the
paths the JSON outputs name are the same for both."""

import json

import numpy as np
import pytest

import orion_kmer_tpu.engine as jax_engine
from orion_kmer_tpu import codec
from orion_kmer_tpu.cli import main as jax_main
from orion_kmer_tpu.db import KmerDb
from orion_kmer_tpu_torch import engine

from .test_cli_classify import DB1_REF1, DB1_REF2, DB2_REF1, INPUT_FASTA_BASIC
from .test_cli_compare import FASTA_DB1, FASTA_DB2
from .test_cli_query import DB_FASTA, QUERY_FASTQ
from .test_fuzz_parity import _EXTS, _random_reads
from .test_torch_count import _assert_dirs_equal, _run_both, port_cpu
from .test_torch_ingest import jax_native_loaded  # noqa: F401  (a fixture)
from .util import write_file

# the JAX CLI and engine read through the JAX package's native parser
pytestmark = pytest.mark.usefixtures("jax_native_loaded")


def _db(tmp_path, name, k, files):
    """Build a DB with the JAX CLI from (file name, content) pairs."""
    gdir = tmp_path / "genomes"
    gdir.mkdir(exist_ok=True)
    paths = [write_file(gdir / f, text) for f, text in files]
    out = tmp_path / name
    assert jax_main(["build", "-k", k, "-o", out, "-g", *paths]) == 0
    return out


def _tiny_batch(monkeypatch):
    """A 640-position batch in both packages, so records straddle batch
    cuts and halos (tests/test_fuzz_parity.py:_tiny_batch)."""
    monkeypatch.setattr(jax_engine, "_DEFAULT_BATCH", 640)
    monkeypatch.setenv("ORION_KMER_BATCH", "640")


def _sub(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    return d


def _error_of_both(capsys, argv):
    """Exit code and stderr of both CLIs; they must agree."""
    outs = []
    for main in (jax_main, port_cpu):
        rc = main(argv)
        outs.append((rc, capsys.readouterr().err))
    assert outs[0] == outs[1]
    assert outs[1][0] == 1
    return outs[1][1]


# ------------------------------------------------------------------ compare


def _compare_dbs(tmp_path):
    return {
        "db1": lambda: _db(tmp_path, "db1.db", 4, [("db1.fa", FASTA_DB1)]),
        "db2": lambda: _db(tmp_path, "db2.db", 4, [("db2.fa", FASTA_DB2)]),
        "ident": lambda: _db(tmp_path, "ident.db", 3, [("identical.fa", ">s1\nACGTACGTACGT\n")]),
        "n1": lambda: _db(tmp_path, "n1.db", 5, [("n1.fa", ">s1\nAAAAACCCCC\n")]),
        "n2": lambda: _db(tmp_path, "n2.db", 5, [("n2.fa", ">s2\nTTTTTGGGGG\n")]),
        "empty": lambda: _db(tmp_path, "empty.db", 5, [("empty.fa", ">h1\n>h2\n")]),
    }


@pytest.mark.parametrize("pair", [("db1", "db2"), ("ident", "ident"), ("n1", "n2"), ("empty", "empty"), ("n1", "empty")])
def test_compare_cli_matches_jax(tmp_path, pair):
    """tests/test_cli_compare.py's fixtures, and an empty side."""
    dbs = _compare_dbs(tmp_path)
    d1, d2 = dbs[pair[0]](), dbs[pair[1]]() if pair[1] != pair[0] else None
    d2 = d2 or d1
    a, b = _run_both(tmp_path, lambda d: ["compare", "--db1", d1, "--db2", d2, "-o", d / "cmp.json"])
    _assert_dirs_equal(a, b)


def test_compare_error_paths_match_jax(tmp_path, capsys):
    d3 = _db(tmp_path, "k3.db", 3, [("k3.fa", FASTA_DB1)])
    d4 = _db(tmp_path, "k4.db", 4, [("k4.fa", FASTA_DB2)])
    err = _error_of_both(capsys, ["compare", "--db1", d3, "--db2", d4, "-o", tmp_path / "o.json"])
    assert "incompatible k-mer sizes (overall comparison): 3 vs 4" in err
    bad = tmp_path / "corrupt.db"
    bad.write_bytes(b"\x07" + b"\xff" * 64)
    assert "corrupt.db" in _error_of_both(capsys, ["compare", "--db1", d3, "--db2", bad, "-o", tmp_path / "o.json"])
    assert "missing.db" in _error_of_both(
        capsys, ["compare", "--db1", d3, "--db2", tmp_path / "missing.db", "-o", tmp_path / "o.json"]
    )


def _random_db(rng, k, names, pool):
    """A KmerDb over ``names``; each reference draws from ``pool`` (so two
    DBs from one pool overlap), and a name ending in "empty" stays empty."""
    db = KmerDb(k=k)
    for name in names:
        n = 0 if name.endswith("empty") else int(rng.integers(1, pool.shape[0]))
        db.add_reference(name, rng.choice(pool, size=n, replace=False))
    return db


@pytest.mark.parametrize("k", [1, 21, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_compare_fuzz_matches_jax(tmp_path, seed, k):
    """Randomized compare: overlapping DBs, an empty reference, reference
    names shared by the two DBs, and the all-ones key at k = 32."""
    rng = np.random.default_rng(100 * seed + k)
    top = np.uint64((1 << (2 * k)) - 1)  # the all-ones key of this k
    pool = np.unique(np.concatenate([rng.integers(0, 1 << 64, size=3000, dtype=np.uint64) & top, np.array([0, top], np.uint64)]))
    d1 = tmp_path / "a.db"
    d2 = tmp_path / "b.db.gz"
    _random_db(rng, k, ["shared.fa", "only1.fa", "z_empty"], pool).save(d1)
    _random_db(rng, k, ["shared.fa", "x.fa"], pool).save(d2)
    a, b = _run_both(tmp_path, lambda d: ["compare", "--db1", d1, "--db2", d2, "-o", d / "cmp.json"])
    _assert_dirs_equal(a, b)
    got = json.loads((b / "cmp.json").read_text())
    u1, u2 = KmerDb.load(d1).get_all_kmers_unified(), KmerDb.load(d2).get_all_kmers_unified()
    assert got["intersection_size"] == np.intersect1d(u1, u2).shape[0]


# -------------------------------------------------------------------- query


@pytest.mark.parametrize("min_hits", [None, 2, 8, 10])
@pytest.mark.parametrize("reads,out", [("q.fastq", "ids.txt"), ("q.fastq.gz", "ids.txt.gz")])
def test_query_cli_matches_jax(tmp_path, min_hits, reads, out):
    """tests/test_cli_query.py's fixture, with .gz reads and output."""
    db = _db(tmp_path, "db.db", 4, [("db.fa", DB_FASTA)])
    r = write_file(tmp_path / reads, QUERY_FASTQ)
    extra = [] if min_hits is None else ["-c", min_hits]
    a, b = _run_both(tmp_path, lambda d: ["query", "-d", db, "-r", r, "-o", d / out, *extra])
    _assert_dirs_equal(a, b)


def test_query_raw_bytes_and_empty_db_match_jax(tmp_path):
    """Raw read bytes (U is not T, query.rs:80-81), and a DB that holds no
    k-mer at all."""
    db = _db(tmp_path, "db.db", 4, [("db.fa", ">r\nACGTAAAA\n")])
    empty = _db(tmp_path, "empty.db", 4, [("e.fa", ">h\nAC\n")])
    r = write_file(tmp_path / "r.fq", "@u_read\nACGU\n+\n!!!!\n@t_read\nACGT\n+\n!!!!\n@l_read\nacgtaaaa\n+\n!!!!!!!!\n")
    for d_ in (db, empty):
        a, b = _run_both(_sub(tmp_path, d_.stem), lambda d: ["query", "-d", d_, "-r", r, "-o", d / "ids.txt", "-c", 0])
        _assert_dirs_equal(a, b)


def test_query_error_paths_match_jax(tmp_path, capsys):
    db = _db(tmp_path, "db.db", 4, [("db.fa", DB_FASTA)])
    empty = tmp_path / "empty.fastq"
    empty.write_bytes(b"")
    err = _error_of_both(capsys, ["query", "-d", db, "-r", empty, "-o", tmp_path / "o"])
    assert "Failed to open or parse FASTQ file" in err
    reads = write_file(tmp_path / "r.fastq", QUERY_FASTQ)
    assert "k-mer database" in _error_of_both(capsys, ["query", "-d", tmp_path / "none.db", "-r", reads, "-o", tmp_path / "o"])
    assert "none.fastq" in _error_of_both(capsys, ["query", "-d", db, "-r", tmp_path / "none.fastq", "-o", tmp_path / "o"])


@pytest.mark.parametrize("seed,k,min_hits", [(20, 9, 1), (21, 15, 3), (22, 31, 2)])
def test_query_fuzz_matches_jax(tmp_path, monkeypatch, seed, k, min_hits):
    """The query fuzz of tests/test_fuzz_parity.py, same seeds, 640-position
    batches."""
    _tiny_batch(monkeypatch)
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=1500))
    db = _db(tmp_path, "g.db", k, [(f"g.fa{_EXTS[seed % 4]}", f">g\n{genome}\n")])
    reads = _random_reads(rng, 60, k, genome)
    r = write_file(
        tmp_path / f"reads.fq{_EXTS[(seed + 1) % 4]}",
        "".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n" for rid, seq in reads),
    )
    a, b = _run_both(tmp_path, lambda d: ["query", "-d", db, "-r", r, "-o", d / "hits.txt", "-c", min_hits])
    _assert_dirs_equal(a, b)
    assert (b / "hits.txt").read_text()


def test_query_records_path_matches_query_file(tmp_path, monkeypatch):
    """Without the native parser, query runs through query_records, which
    must give the same ids."""
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=800))
    db = KmerDb.load(_db(tmp_path, "g.db", 11, [("g.fa", f">g\n{genome}\n")])).get_all_kmers_unified()
    reads = _random_reads(rng, 80, 11, genome)
    r = write_file(tmp_path / "r.fq", "".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n" for rid, seq in reads))
    monkeypatch.setenv("ORION_KMER_BATCH", "512")
    native = engine.query_file(db, r, 11, 1, "cpu")
    monkeypatch.setattr(engine.native, "available", lambda: False)
    assert engine.query_file(db, r, 11, 1, "cpu") == native
    assert len(native) > 10


@pytest.mark.parametrize("native_parser", [True, False])
def test_query_hits_exact_against_oracle(tmp_path, monkeypatch, native_parser):
    """Per-read hit counts across 512-position batches, through the native
    stream and the in-memory path, against codec windows + np.isin; and
    query_file's ids at every threshold are the reads with that many hits."""
    k = 11
    rng = np.random.default_rng(6)
    genome = "".join(rng.choice(list("ACGT"), size=800))
    db = KmerDb.load(_db(tmp_path, "g.db", k, [("g.fa", f">g\n{genome}\n")])).get_all_kmers_unified()
    reads = _random_reads(rng, 80, k, genome)
    r = write_file(tmp_path / "r.fq", "".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n" for rid, seq in reads))
    monkeypatch.setenv("ORION_KMER_BATCH", "512")
    if not native_parser:
        monkeypatch.setattr(engine.native, "available", lambda: False)
    ids, lens, hits = engine.query_hits(db, r, k, "cpu")
    assert ids == [rid.encode() for rid, _ in reads]
    assert lens == [len(seq) for _, seq in reads]
    exp = [int(np.isin(codec.extract_kmers_np(codec.seq_to_codes(seq.encode(), normalize=False), k), db).sum())
           for _, seq in reads]
    assert hits.tolist() == exp
    assert len(set(exp)) > 5
    for c in sorted(set(exp)):
        want = [rid.encode() for (rid, seq), h in zip(reads, exp) if h >= c and len(seq) >= k]
        assert engine.query_file(db, r, k, c, "cpu") == want


def test_query_db_and_reads_cross_bucket_boundary(tmp_path):
    """tests/test_boundaries.py:125: a DB of > 4096 13-mers and 4200 reads."""
    k = 13
    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    db = _db(tmp_path, "g.db", k, [("g.fa", f">g\n{genome}\n")])
    reads = []
    for i in range(4200):
        if i % 3 == 0:
            start = int(rng.integers(0, len(genome) - 40))
            seq = genome[start : start + 40]
        else:
            seq = "".join(rng.choice(list("ACGT"), size=40))
        reads.append((f"read{i}", seq))
    r = write_file(tmp_path / "reads.fq", "".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n" for rid, seq in reads))
    a, b = _run_both(
        tmp_path, lambda d: ["query", "-d", db, "-r", r, "-o", d / "h1.txt", "-c", 1]
    )
    for d in (a, b):
        (d / "h1.txt").rename(d / "keep1.txt")
    a5, b5 = _run_both(_sub(tmp_path, "c5"), lambda d: ["query", "-d", db, "-r", r, "-o", d / "h5.txt", "-c", 5])
    _assert_dirs_equal(a, b)
    _assert_dirs_equal(a5, b5)


# ----------------------------------------------------------------- classify


def _classify_dbs(tmp_path):
    db1 = _db(tmp_path, "db1.db", 4, [("db1_refA.fa", DB1_REF1), ("db1_refB.fa", DB1_REF2)])
    db2 = _db(tmp_path, "db2.db", 4, [("db2_refC.fa", DB2_REF1)])
    return db1, db2


@pytest.mark.parametrize(
    "extra",
    [
        ["--kmer-size", 4],
        ["--min-kmer-frequency", 2],
        ["--min-coverage", 0.5],
        ["--min-coverage", 0.1],
    ],
)
@pytest.mark.parametrize("out", ["out.json", "out.json.gz"])
def test_classify_cli_matches_jax(tmp_path, extra, out):
    """tests/test_cli_classify.py's fixtures, with the TSV and .gz output."""
    db1, db2 = _classify_dbs(tmp_path)
    inp = write_file(tmp_path / "input.fa", INPUT_FASTA_BASIC)
    a, b = _run_both(
        tmp_path,
        lambda d: ["classify", "-i", inp, "-d", db1, "-d", db2, "-o", d / out, "--output-tsv", d / "o.tsv", *extra],
    )
    _assert_dirs_equal(a, b)


def test_classify_sorted_references_and_empty_input_match_jax(tmp_path):
    db = _db(tmp_path, "db.db", 4, [("zz.fa", DB1_REF1), ("aa.fa", DB1_REF2), ("mm.fa", DB2_REF1)])
    for name, text in (("in.fa", INPUT_FASTA_BASIC), ("short.fa", ">s\nACG\n")):
        inp = write_file(tmp_path / name, text)
        a, b = _run_both(_sub(tmp_path, name.split(".")[0]), lambda d: ["classify", "-i", inp, "-d", db, "-o", d / "o.json", "--output-tsv", d / "o.tsv"])
        _assert_dirs_equal(a, b)


def test_classify_error_paths_match_jax(tmp_path, capsys):
    db4 = _db(tmp_path, "k4.db", 4, [("dbk4.fa", DB1_REF1)])
    db3 = _db(tmp_path, "k3.db", 3, [("dbk3.fa", ">seq\nACG\n")])
    inp = write_file(tmp_path / "in.fa", INPUT_FASTA_BASIC)
    err = _error_of_both(capsys, ["classify", "-i", inp, "-d", db4, "--kmer-size", 3, "-o", tmp_path / "o.json"])
    assert "User-provided k-mer size 3 does not match k-mer size 4 from database" in err
    err = _error_of_both(capsys, ["classify", "-i", inp, "-d", db4, "-d", db3, "-o", tmp_path / "o.json"])
    assert "Effective k-mer size 4 (from first database) does not match k-mer size 3" in err


@pytest.mark.parametrize("seed,k,min_freq,min_cov", [(30, 7, 1, 0.0), (31, 13, 2, 0.25)])
def test_classify_fuzz_matches_jax(tmp_path, monkeypatch, seed, k, min_freq, min_cov):
    """The classify fuzz of tests/test_fuzz_parity.py, same seeds."""
    _tiny_batch(monkeypatch)
    rng = np.random.default_rng(seed)
    genomes = {}
    for i in range(4):
        genomes[f"ref{i}.fa{_EXTS[(seed + i) % 4]}"] = "".join(rng.choice(list("ACGT"), size=int(rng.integers(200, 900))))
    db = _db(tmp_path, "refs.db", k, [(n, f">r{i}\n{g}\n") for i, (n, g) in enumerate(genomes.items())])
    recs = _random_reads(rng, 25, k, genomes[sorted(genomes)[0]], max_len=400)
    recs += _random_reads(rng, 10, k, genomes[sorted(genomes)[1]], max_len=400)
    inp = write_file(
        tmp_path / f"in.fa{_EXTS[(seed + 2) % 4]}",
        "".join(f">{rid}.{i}\n{seq}\n" for i, (rid, seq) in enumerate(recs)),
    )
    a, b = _run_both(
        tmp_path,
        lambda d: ["classify", "-i", inp, "-d", db, "-o", d / "o.json", "--output-tsv", d / "o.tsv",
                   "--min-kmer-frequency", min_freq, "--min-coverage", min_cov],
    )
    _assert_dirs_equal(a, b)


def test_classify_max_join_seam_matches_jax(tmp_path, monkeypatch):
    """tests/test_boundaries.py:171: the port joins in chunks of at most
    3400 reference k-mers (two references a chunk, three chunks), the JAX
    package in one; the outputs must not differ, and they match the
    numpy oracle."""
    k = 13
    rng = np.random.default_rng(23)
    genomes = {f"ref{i}.fa": "".join(rng.choice(list("ACGT"), size=1600)) for i in range(6)}
    db = _db(tmp_path, "refs.db", k, [(n, f">{n}\n{s}\n") for n, s in genomes.items()])
    parts = [genomes[f"ref{i}.fa"][:800] for i in range(3)] + ["".join(rng.choice(list("ACGT"), size=4000))]
    inp = write_file(tmp_path / "in.fa", "".join(f">s{i}\n{p}\n" for i, p in enumerate(parts)))
    joins = []
    orig = engine.ClassifyJoiner.join

    def counting(self, ref_vals):
        joins.append(ref_vals.shape[0])
        return orig(self, ref_vals)

    monkeypatch.setattr(engine.ClassifyJoiner, "MAX_JOIN", 3400)
    monkeypatch.setattr(engine.ClassifyJoiner, "join", counting)
    a, b = _run_both(tmp_path, lambda d: ["classify", "-i", inp, "-d", db, "-o", d / "o.json", "--output-tsv", d / "o.tsv"])
    _assert_dirs_equal(a, b)
    assert len(joins) == 3 and max(joins) <= 3400
    refs = {r["reference_name"]: r for r in json.loads((b / "o.json").read_text())["databases_analyzed"][0]["references"]}
    counts = {}
    for p in parts:
        for v in codec.extract_kmers_np(codec.seq_to_codes(p.encode()), k).tolist():
            counts[v] = counts.get(v, 0) + 1
    for name, seq in genomes.items():
        ref = set(codec.extract_kmers_np(codec.seq_to_codes(seq.encode()), k).tolist())
        matched = [v for v in counts if v in ref]
        assert refs[name]["input_kmers_hitting_reference"] == len(matched)
        assert refs[name]["sum_depth_of_matched_kmers_in_input"] == sum(counts[v] for v in matched)
