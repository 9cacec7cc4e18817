"""The port's parse spread over parser threads (``host.native_chunks`` with
``threads`` > 1) against the serial parse (``threads=1``) and against the
JAX package's ``engine.stream_native_chunks``: the same (codes, rec_ends,
ids) chunks in the same order, at T = 2, 3 and 8 parser threads and at
chunk sizes of 64 bytes, 1009 bytes (a prime) and 4096 bytes, and the same
error message, from the first bad piece in stream order.

Inputs are made from a seed with numpy: multi-line FASTA with N runs and
lowercase, FASTA of records of 2 and 5 bytes, CRLF files, FASTQ whose quality lines start with '@' and '+',
blank lines between FASTQ records, records longer than a chunk, trailing
whitespace, .gz and .zst files, malformed records in the first, a middle
and the last piece, and empty files.  Then ``count_file`` and
``query_hits`` at -t 1 and -t 8, the bound on the pieces alive at once,
wrong guesses of a cut, and an early stop.

Tolerance: none, every comparison is of bytes or integers.
"""

import threading
import time

import numpy as np
import pytest

from orion_kmer_tpu import engine as jax_engine
from orion_kmer_tpu_torch import engine, host, staging
from orion_kmer_tpu_torch.ingest import native

from .test_torch_ingest import jax_native_loaded  # noqa: F401  (a fixture)
from .util import write_file

pytestmark = pytest.mark.usefixtures("jax_native_loaded")

THREADS = [2, 3, 8]
CHUNKS = [64, 1009, 4096]
K = 11


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


def fasta_multiline(seed=1, n=40, eol="\n", long=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = long if long and i % 7 == 3 else int(rng.integers(0, 700))
        s = _seq(rng, length, "ACGTacgt")
        if length > 40 and i % 3 == 0:
            p = int(rng.integers(0, length - 30))
            s = s[:p] + "N" * int(rng.integers(1, 30)) + s[p + 30 :]
        lines = [s[j : j + 60] for j in range(0, len(s), 60)]
        out.append(eol.join([f">r{i} desc {i}", *lines]) + eol)
    return "".join(out)


def fastq(seed=2, n=60, eol="\n", blank=False, long=0):
    """Quality lines start with '@' or '+' in turn, and hold both."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = long if long and i % 9 == 4 else int(rng.integers(1, 250))
        s = _seq(rng, length, "ACGTN")
        q = ("@" if i % 2 else "+") + _seq(rng, length - 1, "@+I#5")
        rec = eol.join([f"@q{i}", s, "+" if i % 3 else f"+q{i}", q]) + eol
        if blank and i % 4 == 1:
            rec += eol if i % 8 == 1 else "\r\n"
        out.append(rec)
    return "".join(out)


INPUTS = {
    "fasta_multiline": lambda: fasta_multiline(),
    "fasta_crlf": lambda: fasta_multiline(seed=3, eol="\r\n"),
    "fasta_long_records": lambda: fasta_multiline(seed=4, n=15, long=20_000),
    "fasta_trailing_ws": lambda: fasta_multiline(seed=5) + "\n\n  \n\t\n",
    "fastq_at_plus_quality": lambda: fastq(),
    "fastq_crlf": lambda: fastq(seed=6, eol="\r\n"),
    "fastq_blank_lines": lambda: fastq(seed=7, blank=True),
    "fastq_long_records": lambda: fastq(seed=8, n=30, long=9_000),
    "fastq_trailing_ws": lambda: fastq(seed=9) + "\n\r\n\n",
    # more records than the parser's first guess of one per 16 bytes: it
    # parses again with the exact bound
    "fasta_tiny_records": lambda: "".join(">\n" if i % 3 else f">{i}\nA\n" for i in range(3000)),
}


def _assert_same_chunks(got, exp):
    assert len(got) == len(exp)
    for (gc, gr, gi), (ec, er, ei) in zip(got, exp):
        np.testing.assert_array_equal(gc, ec)
        np.testing.assert_array_equal(gr, er)
        assert gi == ei


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_parallel_chunks_match_serial_and_jax(tmp_path, name, threads, chunk):
    path = write_file(tmp_path / "in.fx", INPUTS[name]())
    for normalize in (True, False):
        stats = host.ParseStats()
        got = list(host.stream_native_chunks(path, K, normalize, chunk_bytes=chunk, threads=threads, stats=stats))
        assert stats.peak <= host.piece_bound(threads)
        serial = list(host.stream_native_chunks(path, K, normalize, chunk_bytes=chunk, threads=1))
        exp = list(jax_engine.stream_native_chunks(path, K, normalize, chunk_bytes=chunk))
        assert len(exp) > 1
        _assert_same_chunks(serial, exp)
        _assert_same_chunks(got, exp)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("suffix", [".gz", ".zst"])
@pytest.mark.parametrize("name", ["fasta_multiline", "fastq_blank_lines"])
def test_parallel_chunks_of_compressed_files(tmp_path, name, suffix, threads):
    path = write_file(tmp_path / f"in.fx{suffix}", INPUTS[name]())
    got = list(host.stream_native_chunks(path, K, chunk_bytes=1009, threads=threads))
    _assert_same_chunks(got, list(host.stream_native_chunks(path, K, chunk_bytes=1009, threads=1)))
    _assert_same_chunks(got, list(jax_engine.stream_native_chunks(path, K, chunk_bytes=1009)))


def _error_of(stream):
    """(chunks yielded before the error, the error's type name and text)."""
    chunks = []
    try:
        for c in stream:
            chunks.append(c)
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        return chunks, str(e)
    return chunks, None


def _malformed(where: str) -> str:
    """FASTQ of 80 records with one bad quality length, or a truncated end."""
    text = fastq(seed=11, n=80)
    recs = text.split("@q")
    if where == "last":
        return text[:-3]  # the last quality line cut short: malformed at eof
    i = {"first": 1, "middle": 40}[where]
    head, seq, plus, qual, _ = recs[i].split("\n")
    recs[i] = "\n".join([head, seq, plus, qual + "I", ""])
    return "@q".join(recs)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_malformed_record_raises_the_serial_error(tmp_path, where, threads, chunk):
    path = write_file(tmp_path / "bad.fq", _malformed(where))
    got_chunks, got_err = _error_of(host.stream_native_chunks(path, K, chunk_bytes=chunk, threads=threads))
    exp_chunks, exp_err = _error_of(host.stream_native_chunks(path, K, chunk_bytes=chunk, threads=1))
    jax_chunks, jax_err = _error_of(jax_engine.stream_native_chunks(path, K, chunk_bytes=chunk))
    assert exp_err is not None and "malformed record" in exp_err
    assert got_err == exp_err == jax_err
    _assert_same_chunks(got_chunks, exp_chunks)
    _assert_same_chunks(got_chunks, jax_chunks)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("text", ["", " \n\t\r\n", "not a record\nACGT\n"], ids=["empty", "whitespace", "unknown"])
def test_empty_and_unknown_inputs_raise_the_serial_error(tmp_path, text, threads):
    path = write_file(tmp_path / "in.fa", text)
    got = _error_of(host.stream_native_chunks(path, K, chunk_bytes=64, threads=threads))
    exp = _error_of(host.stream_native_chunks(path, K, chunk_bytes=64, threads=1))
    assert got[1] is not None and got[1] == exp[1] == _error_of(jax_engine.stream_native_chunks(path, K, chunk_bytes=64))[1]
    assert got[0] == exp[0] == []


def test_guesses_hold_on_regular_inputs(tmp_path):
    """On FASTA and strict FASTQ every guessed cut is the serial cut, so no
    piece is parsed twice."""
    for name in ("fasta_multiline", "fasta_crlf", "fastq_at_plus_quality", "fastq_crlf", "fastq_blank_lines"):
        path = write_file(tmp_path / f"{name}.fx", INPUTS[name]())
        stats = host.ParseStats()
        n = len(list(host.native_chunks(path, K, chunk_bytes=1009, threads=3, stats=stats)))
        assert n > 10 and stats.misses == 0, name


def test_wrong_guesses_still_give_the_serial_chunks(tmp_path, monkeypatch):
    """Every guess off by a seeded random amount: each piece is rebuilt and
    parsed again in order, and the chunks are the serial ones."""
    rng = np.random.default_rng(12)
    real = host.guess_cut
    monkeypatch.setattr(host, "guess_cut", lambda buf, fmt: max(0, min(len(buf), real(buf, fmt) + int(rng.integers(-50, 50)))))
    for name in ("fasta_multiline", "fastq_blank_lines", "fastq_long_records"):
        path = write_file(tmp_path / f"{name}.fx", INPUTS[name]())
        stats = host.ParseStats()
        got = list(host.stream_native_chunks(path, K, chunk_bytes=1009, threads=3, stats=stats))
        assert stats.misses > 0
        _assert_same_chunks(got, list(host.stream_native_chunks(path, K, chunk_bytes=1009, threads=1)))
        assert stats.peak <= host.piece_bound(3)


@pytest.mark.parametrize("guess", ["start", "end"])
def test_a_guess_at_either_end_still_gives_the_serial_chunks(tmp_path, monkeypatch, guess):
    """A guess of each piece's start, or of its end, whatever its bytes.
    With records of 16 bytes and chunks of 64 every chunk ends on a
    record end, so the serial carry is empty and the start is wrong at
    every piece; on FASTA the end is wrong wherever a record is cut."""
    monkeypatch.setattr(host, "guess_cut", lambda buf, fmt: 0 if guess == "start" else len(buf))
    fixed = "".join(f"@r{i % 10}\nACGT\n+\nIIII\n" for i in range(100))
    misses = 0
    for text, chunk in ((fixed, 64), (fixed, 50), (fasta_multiline(seed=18), 1009)):
        path = write_file(tmp_path / "in.fx", text)
        stats = host.ParseStats()
        got = list(host.stream_native_chunks(path, K, chunk_bytes=chunk, threads=3, stats=stats))
        misses += stats.misses
        _assert_same_chunks(got, list(host.stream_native_chunks(path, K, chunk_bytes=chunk, threads=1)))
    assert misses > 10


def test_rebatch_copies_only_batches_that_span_two_chunks():
    rng = np.random.default_rng(19)
    for sizes in (rng.integers(0, 3000, 40), rng.integers(2000, 9000, 40)):
        arrays = [rng.integers(0, 5, int(n), dtype=np.uint8) for n in sizes]
        got = list(host._rebatch_arrays(iter(arrays), K, 1000))
        exp = [pb.codes for pb in jax_engine._rebatch_codes(((a, None, None) for a in arrays), K, 1000)]
        assert len(got) == len(exp) > 40
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e)
        copies = sum(not any(np.shares_memory(g, a) for a in arrays) for g in got)
        assert copies <= 2 * len(arrays)  # a cut between arrays lies in at most two batches
    assert copies < len(got) // 2
    with pytest.raises(ValueError, match="no 11-mer window"):
        list(host._rebatch_arrays(iter(arrays), K, K - 1))


@pytest.mark.parametrize("threads", THREADS)
def test_pieces_stay_within_the_bound_behind_a_slow_consumer(tmp_path, threads):
    path = write_file(tmp_path / "in.fq", fastq(seed=13, n=300))
    got, stats = [], host.ParseStats()
    for chunk in host.stream_native_chunks(path, K, chunk_bytes=1009, threads=threads, stats=stats):
        time.sleep(0.002)  # the reader and the parsers run ahead and wait
        got.append(chunk)
    assert host.piece_bound(threads) >= stats.peak >= threads
    _assert_same_chunks(got, list(host.stream_native_chunks(path, K, chunk_bytes=1009, threads=1)))


def test_stress_more_threads_than_cores_with_fast_switching(tmp_path):
    """Twice as many parser threads as cores, 64-byte chunks and a thread
    switch every microsecond, with the codes of every chunk held to the
    end (so no parse buffer may be handed out while a chunk uses it):
    every chunk is the serial one, and the pieces stay within the bound."""
    import os
    import sys

    path = write_file(tmp_path / "in.fq", fastq(seed=20, n=200, blank=True))
    threads = 2 * (os.cpu_count() or 1)
    exp = list(host.stream_native_chunks(path, K, chunk_bytes=64, threads=1))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            stats = host.ParseStats()
            got = list(host.stream_native_chunks(path, K, chunk_bytes=64, threads=threads, stats=stats))
            _assert_same_chunks(got, exp)
            assert stats.peak <= host.piece_bound(threads)
    finally:
        sys.setswitchinterval(interval)


def test_early_stop_ends_every_thread(tmp_path):
    path = write_file(tmp_path / "in.fq", fastq(seed=14, n=300))
    before = threading.active_count()
    stream = host.stream_native_chunks(path, K, chunk_bytes=1009, threads=4)
    next(stream)
    stream.close()
    batches = staging.staged_batches(path, K, True, 512, staging.torch.device("cpu"))
    prefetched = host._prefetch(batches, depth=2)
    next(prefetched)
    prefetched.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_parse_threads_follow_dash_t(monkeypatch):
    monkeypatch.setenv("ORION_KMER_THREADS", "1")
    assert host.parse_threads() == 1
    monkeypatch.setenv("ORION_KMER_THREADS", "3")
    assert host.parse_threads() == min(3, host.MAX_PARSE_THREADS)
    monkeypatch.setenv("ORION_KMER_THREADS", "100000")
    assert host.parse_threads() == host.MAX_PARSE_THREADS
    monkeypatch.delenv("ORION_KMER_THREADS")
    assert host.parse_threads() == max(1, min(__import__("os").cpu_count() or 1, host.MAX_PARSE_THREADS))


def test_count_and_query_equal_at_one_and_eight_threads(tmp_path, monkeypatch):
    reads = write_file(tmp_path / "reads.fq", fastq(seed=15, n=400, long=3_000))
    genome = write_file(tmp_path / "g.fa", fasta_multiline(seed=16, n=30))
    monkeypatch.setattr(host, "CHUNK_BYTES", 4096)
    monkeypatch.setenv("ORION_KMER_BATCH", "2048")
    results = {}
    for t in ("1", "8"):
        monkeypatch.setenv("ORION_KMER_THREADS", t)
        db_vals, _ = engine.count_file(genome, K, "cpu")
        results[t] = (engine.count_file(reads, K, "cpu"), engine.query_hits(db_vals, reads, K, "cpu"))
    (c1, q1), (c8, q8) = results["1"], results["8"]
    for a, b in zip(c1, c8):
        np.testing.assert_array_equal(a, b)
    assert q1[0] == q8[0] and q1[1] == q8[1]
    np.testing.assert_array_equal(q1[2], q8[2])
    assert c1[0].shape[0] > 1000 and int(q1[2].sum()) > 0


def test_pack_into_given_arrays_matches_new_arrays():
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 5, 1000, dtype=np.uint8) * np.uint8(1)
    codes[codes == 4] = 255
    lanes, inv = np.empty(1024 // 16, np.uint32), np.empty(1024 // 32, np.uint32)
    out = host.pack_for_transfer(codes, 1024, out=(lanes, inv))
    assert out[0] is lanes and out[1] is inv
    for g, e in zip(out, native.pack_wire(codes, 1024)):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("parts", [1, 3, 4])
@pytest.mark.parametrize("n,size", [(0, 32), (31, 32), (100, 4096), (4096, 4096), (16_379, 16_384), (5000, 8192)])
def test_pinned_ring_split_pack_matches_one_pack(n, size, parts):
    """The ring's pack in slices of whole wire words on its threads (run
    here on plain arrays) writes what one pack of the whole batch writes."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.random(n) < 0.05] = 255
    ring = staging.PinnedRing(staging.torch.device("cpu"), parts)
    try:
        lanes, inv = np.full(size // 16, 7, np.uint32), np.full(size // 32, 7, np.uint32)
        ring._pack(codes, size, lanes, inv)
    finally:
        ring.close()
    for g, e in zip((lanes, inv), host.pack_for_transfer(codes, size)):
        np.testing.assert_array_equal(g, e)
