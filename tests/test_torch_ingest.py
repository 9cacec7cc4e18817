"""The port's ingest without its native parser, and the JAX reference's
native parser as the port tests that call the JAX CLI need it.

- With ``ORION_KMER_NATIVE=0`` the port parses in Python.  Its ``count``,
  ``build``, ``query`` and ``classify`` read plain, .gz, .xz and .zst
  FASTA and FASTQ, byte for byte against the numpy oracle of the port's
  ``codec.py`` (the helpers of ``chip_smoke.py``).
- ``jax_native_loaded`` makes sure ``orion_kmer_tpu.ingest.native`` is
  loaded.  That module compiles into one shared temporary path, so when
  several test processes build it at once some of them lose the race,
  give up on the library for their lifetime and fall back to the JAX
  package's Python parser, which cannot read .zst.  The fixture loads it
  again; by then the process that won has finished the library.
"""

import time

import numpy as np
import pytest

import chip_smoke as oracle
from orion_kmer_tpu.cli import main as jax_main
from orion_kmer_tpu_torch import codec
from orion_kmer_tpu_torch.cli import main as port_main
from orion_kmer_tpu_torch.db import KmerDb
from orion_kmer_tpu_torch.ingest import native as port_native

from .util import write_file

K = 21


@pytest.fixture
def jax_native_loaded(monkeypatch):
    """The JAX package's native parser, loaded again if this process gave
    up on it while another process was still building it."""
    from orion_kmer_tpu.ingest import native as jax_native

    for _ in range(40):
        if jax_native._lib_failed:
            monkeypatch.setattr(jax_native, "_lib", None)
            monkeypatch.setattr(jax_native, "_lib_failed", False)
        if jax_native.available():
            break
        time.sleep(0.5)
    assert jax_native.available()


@pytest.fixture
def python_parser(monkeypatch):
    """The port with its native parser switched off by ORION_KMER_NATIVE=0."""
    monkeypatch.setenv("ORION_KMER_NATIVE", "0")
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_lib_failed", False)
    assert not port_native.available()


def port_cpu(argv):
    return port_main(["--device", "cpu", *map(str, argv)])


def _genome_and_reads(seed):
    """A random genome and 40 reads: slices of it, random reads, reads
    shorter than K, N runs and lowercase stretches."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = lut[rng.integers(0, 4, 5000)]
    reads = []
    for i in range(40):
        n = int(rng.integers(5, K)) if i % 10 == 0 else int(rng.integers(K, 300))
        p = int(rng.integers(0, genome.shape[0] - n))
        s = lut[rng.integers(0, 4, n)] if i % 3 == 0 else genome[p : p + n].copy()
        if i % 4 == 1:
            q = int(rng.integers(0, n))
            s[q : q + int(rng.integers(1, 6))] = ord("N")
        if i % 5 == 2:
            s[: n // 2] += 32  # lowercase
        reads.append(s.tobytes())
    return genome.tobytes(), reads


def _text(fmt, reads):
    if fmt == "fq":
        return "".join(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n" for i, r in enumerate(reads))
    return "".join(
        f">r{i} d\n" + "\n".join(r[j : j + 60].decode() for j in range(0, len(r), 60)) + "\n"
        for i, r in enumerate(reads)
    )


@pytest.mark.parametrize("ext", ["", ".gz", ".xz", ".zst"])
@pytest.mark.parametrize("fmt", ["fa", "fq"])
def test_python_parser_reads_every_compression(tmp_path, python_parser, fmt, ext):
    genome, reads = _genome_and_reads(len(ext) + (fmt == "fq"))
    path = write_file(tmp_path / f"in.{fmt}{ext}", _text(fmt, reads))

    out, hist = tmp_path / "count.tsv", tmp_path / "h.txt"
    assert port_cpu(["count", "-k", K, "-i", path, "-o", out, "--histogram", hist]) == 0
    vals, counts = oracle.oracle_counts(np, codec, reads, K)
    assert out.read_bytes() == oracle.render_tsv(np, vals, counts, K)
    assert int(np.loadtxt(hist, dtype=np.int64, ndmin=2)[:, 1].sum()) == vals.shape[0]

    ref = write_file(tmp_path / "genome.fa", f">g\n{genome.decode()}\n")
    db = tmp_path / "db.db"
    assert port_cpu(["build", "-k", K, "-g", ref, path, "-o", db]) == 0
    exp = KmerDb(k=K)
    exp.add_reference("genome.fa", oracle.oracle_counts(np, codec, [genome], K)[0])
    exp.add_reference(path.name, vals)
    assert db.read_bytes() == exp.to_bincode()

    union = exp.get_all_kmers_unified()
    hits = oracle.window_hits(np, codec, reads, K, union)
    head = b"r%d" if fmt == "fq" else b"r%d d"  # query writes the whole header
    for c in (1, 20):
        ids = tmp_path / f"q{c}.txt"
        assert port_cpu(["query", "-d", db, "-r", path, "-o", ids, "-c", c]) == 0
        want = b"".join(head % i + b"\n" for i, (r, h) in enumerate(zip(reads, hits.tolist())) if h >= c and len(r) >= K)
        assert ids.read_bytes() == want
    assert 0 < want.count(b"\n") < len(reads)

    js, tsv = tmp_path / "cl.json", tmp_path / "cl.tsv"
    assert port_cpu(["classify", "-i", path, "-d", db, "-o", js, "--min-kmer-frequency", 2, "--output-tsv", tsv]) == 0
    keep = counts >= 2
    assert keep.any()
    oracle.check_classify(np, js, tsv, path, db, exp.references, vals[keep], counts[keep])


def test_jax_cli_reads_zst_once_the_fixture_reloads_its_parser(tmp_path, monkeypatch, request):
    """A process that lost the build race: the JAX CLI fails on .zst until
    jax_native_loaded loads the native parser again."""
    from orion_kmer_tpu.ingest import native as jax_native

    _, reads = _genome_and_reads(7)
    path = write_file(tmp_path / "in.fa.zst", _text("fa", reads))
    out = tmp_path / "out.tsv"
    argv = ["count", "-k", K, "-i", path, "-o", out]
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_lib_failed", True)
    assert jax_main(argv) == 1
    request.getfixturevalue("jax_native_loaded")
    assert jax_main(argv) == 0
    vals, counts = oracle.oracle_counts(np, codec, reads, K)
    assert out.read_bytes() == oracle.render_tsv(np, vals, counts, K)
