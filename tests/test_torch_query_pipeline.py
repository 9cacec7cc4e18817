"""The port's streamed ``query``: ``host._rebatch_records``, the batch
cutter, against the rolling-buffer loop it replaced (kept here as the
plain version), and ``engine.query_hits``/``query_file`` against the JAX
package's ``engine.query_file`` on the CPU and a window-hit oracle of
``codec.py`` at several thresholds, -t 1, 2 and 4, FASTA, FASTQ and
``.gz`` inputs, and k = 32 with the ``T*40`` edge."""

import gzip

import numpy as np
import pytest

import orion_kmer_tpu.engine as jax_engine
from orion_kmer_tpu import codec
from orion_kmer_tpu_torch import engine, host

from .test_torch_ingest import jax_native_loaded  # noqa: F401  (a fixture)

# the JAX engine reads through the JAX package's native parser
pytestmark = pytest.mark.usefixtures("jax_native_loaded")

ALL_ONES = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def rolling_batches(chunks, k, B):
    """The plain version: the rolling-buffer loop of ``query_hits`` before
    the cutter, yielding (piece, batch-local starts, record indices)."""
    sep = k - 1
    buf = np.empty(0, np.uint8)
    bstarts = np.empty(0, np.int64)
    bends = np.empty(0, np.int64)
    brids = np.empty(0, np.int64)
    n_records = 0
    for codes, rec_ends, _ in chunks:
        base = buf.shape[0]
        starts = np.concatenate([[0], rec_ends[:-1] + sep])
        buf = np.concatenate([buf, codes]) if base else codes
        bstarts = np.concatenate([bstarts, base + starts])
        bends = np.concatenate([bends, base + rec_ends + sep])
        brids = np.concatenate([brids, n_records + np.arange(rec_ends.shape[0], dtype=np.int64)])
        n_records += rec_ends.shape[0]
        while buf.shape[0] >= B:
            mask = bstarts < B
            yield buf[:B], bstarts[mask], brids[mask]
            cut = B - sep
            buf = buf[cut:]
            keep = bends > cut
            bstarts, bends, brids = bstarts[keep] - cut, bends[keep] - cut, brids[keep]
    if buf.shape[0]:
        yield buf, bstarts, brids


def make_chunks(rng, k, lengths_per_chunk):
    """Chunks laid out as the native parser lays them out: each record's
    codes (a few invalid) followed by k - 1 invalid positions."""
    sep = np.full(k - 1, codec.INVALID_CODE, np.uint8)
    chunks, rid = [], 0
    for lengths in lengths_per_chunk:
        parts, ends, ids, pos = [], [], [], 0
        for n in lengths:
            rec = rng.integers(0, 4, n).astype(np.uint8)
            rec[rng.random(n) < 0.02] = codec.INVALID_CODE
            parts += [rec, sep]
            pos += n
            ends.append(pos)
            pos += k - 1
            ids.append(b"r%d" % rid)
            rid += 1
        chunks.append((np.concatenate(parts), np.array(ends, np.int64), ids))
    return chunks


def assert_cutter_matches_plain(chunks, k, B):
    got = list(host._rebatch_records(iter(chunks), k, B))
    want = list(rolling_batches(chunks, k, B))
    batches = [g for g in got if g[0].shape[0]]
    assert len(batches) == len(want)
    for (piece, starts, rids, _), (w_piece, w_starts, w_rids) in zip(batches, want):
        np.testing.assert_array_equal(piece, w_piece)
        np.testing.assert_array_equal(starts, w_starts)
        np.testing.assert_array_equal(rids, w_rids)
    # every chunk's ids and lengths come out once, in order, by the last yield
    new = [rec for g in got for rec in g[3]]
    assert [ids for ids, _ in new] == [c[2] for c in chunks]
    for (_, lens), (codes, rec_ends, _) in zip(new, chunks):
        np.testing.assert_array_equal(lens, rec_ends - np.concatenate([[0], rec_ends[:-1] + k - 1]))
    # a piece inside one chunk is a view of it; only a piece across chunks is a copy
    offsets = np.cumsum([0] + [c[0].shape[0] for c in chunks])
    start = 0
    for piece, *_ in batches:
        first = np.searchsorted(offsets, start, side="right") - 1
        inside = start + piece.shape[0] <= offsets[first + 1]
        assert np.shares_memory(piece, chunks[first][0]) == inside
        start += B - (k - 1)
    return batches


@pytest.mark.parametrize("k", [9, 31])
@pytest.mark.parametrize("B_of", ["k", "k+1", "64", "640"])
def test_cutter_yields_the_rolling_buffer_batches(k, B_of):
    """B = k, k + 1, 64 and 640: records that span many batches and many
    chunks, empty records and chunks of one record."""
    B = {"k": k, "k+1": k + 1}.get(B_of) or int(B_of)
    rng = np.random.default_rng(k * 1000 + B)
    lengths = [
        list(rng.integers(0, 200, 40)),
        [1200],
        [0, 0, 5],
        list(rng.integers(0, 20, 60)),
        [700, 1],
    ]
    batches = assert_cutter_matches_plain(make_chunks(rng, k, lengths), k, B)
    assert len(batches) > 10
    assert any(starts[0] < 0 for _, starts, _, _ in batches)  # a record carried across a cut


@pytest.mark.parametrize("B", [64, 640])
def test_cutter_one_position_last_batch(B):
    """At k = 2 a remainder of one position after the last cut makes a
    1-position last batch; the cutter yields it as the loop did."""
    k = 2
    rng = np.random.default_rng(B)
    lengths = [list(rng.integers(1, 300, 30)), list(rng.integers(1, 300, 30))]
    total = sum(n + 1 for chunk in lengths for n in chunk)
    step = B - 1
    lengths[-1][-1] += (-(total - B)) % step  # total - B a multiple of the step
    batches = assert_cutter_matches_plain(make_chunks(rng, k, lengths), k, B)
    assert batches[-1][0].shape[0] == 1


def test_cutter_without_positions_after_the_last_cut_still_yields_the_ids():
    """k = 1 has no separator: a chunk of empty records adds no position,
    and its ids still come out."""
    rng = np.random.default_rng(3)
    chunks = make_chunks(rng, 1, [[10, 6], [0, 0]])
    got = list(host._rebatch_records(iter(chunks), 1, 8))
    assert got[-1][0].shape[0] == 0 and [ids for ids, _ in got[-1][3]] == [[b"r2", b"r3"]]
    assert_cutter_matches_plain(chunks, 1, 8)


def test_cutter_refuses_a_batch_below_k():
    with pytest.raises(ValueError, match="holds no 9-mer window"):
        list(host._rebatch_records(iter([]), 9, 8))


# ------------------------------------------------------------ query_hits


def genome_and_reads(seed, n_reads, k, long=0):
    """A random genome and reads drawn from it (substitutions, N runs,
    lowercase, reads shorter than k, ``long`` reads of several thousand
    bases), as raw text."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("ACGT"), 4000)
    reads = []
    for i in range(n_reads):
        n = int(rng.integers(1, 120)) if i % 7 else int(rng.integers(0, k))
        if i < long:
            n = int(rng.integers(2000, 4000))
        p = int(rng.integers(0, genome.shape[0] - n)) if n < genome.shape[0] else 0
        r = genome[p : p + n].copy()
        for j in rng.integers(0, max(n, 1), 3):
            if j < n and rng.random() < 0.5:
                r[j] = rng.choice(list("ACGTNacgt"))
        reads.append((f"q{i} desc", "".join(r)))
    return "".join(genome), reads


def oracle_hits(db, reads, k):
    return np.array(
        [int(np.isin(codec.extract_kmers_np(codec.seq_to_codes(s.encode(), normalize=False), k), db).sum())
         for _, s in reads],
        dtype=np.int64,
    )


def write_reads(path, reads, fmt):
    if fmt == "fasta":
        text = "".join(f">{rid}\n" + "\n".join(s[j : j + 60] for j in range(0, len(s), 60)) + "\n" for rid, s in reads)
    else:
        text = "".join(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n" for rid, s in reads)
    if path.suffix == ".gz":
        path.write_bytes(gzip.compress(text.encode()))
    else:
        path.write_text(text)
    return path


@pytest.mark.parametrize("threads", ["1", "2", "4"])
@pytest.mark.parametrize("name", ["r.fa", "r.fq", "r.fq.gz"])
def test_query_hits_match_jax_and_the_oracle(tmp_path, monkeypatch, name, threads):
    """Every read's hits against the oracle, and query_file's ids at
    several thresholds against the oracle and the JAX package's
    query_file, over chunks of 2 KiB and batches of 512 positions."""
    k = 15
    genome, reads = genome_and_reads(int(threads) * 10 + len(name), 200, k, long=3)
    db = np.unique(codec.extract_kmers_np(codec.seq_to_codes(genome.encode()), k))
    path = write_reads(tmp_path / name, reads, "fasta" if name == "r.fa" else "fastq")
    monkeypatch.setattr(host, "CHUNK_BYTES", 2048)
    monkeypatch.setenv("ORION_KMER_BATCH", "512")
    monkeypatch.setenv("ORION_KMER_THREADS", threads)
    ids, lens, hits = engine.query_hits(db, path, k, "cpu")
    want = oracle_hits(db, reads, k)
    assert ids == [rid.encode() for rid, _ in reads]
    assert lens == [len(s) for _, s in reads]
    np.testing.assert_array_equal(hits, want)
    assert len(set(want.tolist())) > 20 and want.max() > 1000
    lens = np.array(lens)
    for c in (1, 10, int(want.max())):
        expect = [rid.encode() for (rid, _), h, n in zip(reads, want, lens) if h >= c and n >= k]
        assert engine.query_file(db, path, k, c, "cpu") == expect
        if c == 10:
            assert jax_engine.query_file(db, path, k, c, batch_positions=512) == expect


@pytest.mark.parametrize("batch", ["40", "64", "4096"])
def test_query_k32_t40_edge(tmp_path, monkeypatch, batch):
    """k = 32: T*40 has nine windows, each canonical A^32 (value 0); a DB
    that also holds the all-ones value (T^32 itself, SENTINEL_KEY once
    flipped) must not match the invalid windows of separators, padding
    and short reads, which hold that key."""
    k = 32
    db = np.array([0, 1, 12345, ALL_ONES], dtype=np.uint64)
    reads = [("t40", "T" * 40), ("short", "T" * 31), ("a33", "A" * 33), ("n", "T" * 20 + "N" + "T" * 20),
             ("t32", "T" * 32), ("mixed", "ACGT" * 20)]
    path = write_reads(tmp_path / "t.fq", reads, "fastq")
    monkeypatch.setenv("ORION_KMER_BATCH", batch)
    ids, lens, hits = engine.query_hits(db, path, k, "cpu")
    want = oracle_hits(db, reads, k)
    np.testing.assert_array_equal(hits, want)
    assert hits.tolist() == [9, 0, 2, 0, 1, 0]
    assert engine.query_file(db, path, k, 1, "cpu") == [b"t40", b"a33", b"t32"]
    assert jax_engine.query_file(db, path, k, 1, batch_positions=4096) == [b"t40", b"a33", b"t32"]


def test_query_stream_launches_each_batch_before_reading_the_last(monkeypatch, tmp_path):
    """query_hits takes its batches through the prefetch thread, and folds
    a batch's hits only after the next batch has been launched."""
    k = 11
    genome, reads = genome_and_reads(5, 200, k)
    db = np.unique(codec.extract_kmers_np(codec.seq_to_codes(genome.encode()), k))
    path = write_reads(tmp_path / "r.fq", reads, "fastq")
    monkeypatch.setenv("ORION_KMER_BATCH", "256")
    monkeypatch.setenv("ORION_KMER_THREADS", "1")  # no prefetch thread of the parse's own
    events = []
    real_hits, real_flush, real_prefetch = engine._batch_hits, engine._LateHits.flush, engine._prefetch

    def batch_hits(*args):
        events.append("launch")
        return real_hits(*args)

    def flush(self):
        if self._pending is not None:
            events.append("fold")
        real_flush(self)

    def prefetch(iterator, depth=None):
        events.append("prefetch")
        return real_prefetch(iterator, depth)

    monkeypatch.setattr(engine, "_batch_hits", batch_hits)
    monkeypatch.setattr(engine._LateHits, "flush", flush)
    monkeypatch.setattr(engine, "_prefetch", prefetch)
    _, _, hits = engine.query_hits(db, path, k, "cpu")
    np.testing.assert_array_equal(hits, oracle_hits(db, reads, k))
    assert events[0] == "prefetch"
    launches = events[1:]
    n = launches.count("launch")
    assert n > 10 and launches == ["launch"] + ["launch", "fold"] * (n - 1) + ["fold"]


def test_query_on_an_empty_stream_of_windows(tmp_path):
    """Reads that are all shorter than k: every id, zero hits, no batch
    with a window."""
    path = write_reads(tmp_path / "r.fa", [("a", "ACG"), ("b", ""), ("c", "ACGTA")], "fasta")
    ids, lens, hits = engine.query_hits(np.array([1, 2], np.uint64), path, 9, "cpu")
    assert ids == [b"a", b"b", b"c"] and lens == [3, 0, 5] and hits.tolist() == [0, 0, 0]
    assert engine.query_file(np.array([1, 2], np.uint64), path, 9, 0, "cpu") == []



@pytest.mark.parametrize(
    "blob, id_ends, keep, want",
    [
        (b"abcde", [1, 1, 3, 5], [True, True, False, True], b"a\n\nde\n"),
        (b"", [0, 0], [True, True], b"\n\n"),
        (b"", [], [], b""),
        (b"xyz", [3], [False], b""),
    ],
)
def test_lines_at_gathers_the_kept_ids(blob, id_ends, keep, want):
    """Empty ids, no ids and nothing kept: each kept id and its newline."""
    got = engine._lines_at(blob, np.array(id_ends, np.int64), np.array(keep, bool))
    assert got == want
