"""The port's host pipeline (orion_kmer_tpu_torch.host) against the
engine.py functions it copies: byte-equal batches, halos, rebatching,
wire packing and host accumulation on the tests/util.py fixtures."""

import numpy as np
import pytest

from orion_kmer_tpu import codec, engine
from orion_kmer_tpu.ingest.fastx import parse_fastx_bytes
from orion_kmer_tpu_torch import host

from .util import SAMPLE1_FASTA, SAMPLE2_FASTQ, TEST_INPUT1_FASTA, TEST_INPUT2_FASTQ, write_file

FIXTURES = {
    "sample1": SAMPLE1_FASTA,
    "sample2": SAMPLE2_FASTQ,
    "input1": TEST_INPUT1_FASTA,
    "input2": TEST_INPUT2_FASTQ,
}


def _long_fasta(seed=5, n_records=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_records):
        s = "".join(rng.choice(list("ACGTNacgt"), size=int(rng.integers(10, 3000))))
        out.append(f">r{i} d\n" + "\n".join(s[j : j + 60] for j in range(0, len(s), 60)) + "\n")
    return "".join(out)


def _assert_batches_equal(got, exp):
    got, exp = list(got), list(exp)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.codes, e.codes)
        np.testing.assert_array_equal(g.invalid, e.invalid)
        if e.owner is None:
            assert g.owner is None
        else:
            np.testing.assert_array_equal(g.owner, e.owner)
        assert g.first_rid == e.first_rid
        assert g.record_ids == e.record_ids


@pytest.mark.parametrize("size", [32, 96, 4096])
def test_pack_for_transfer_matches_engine(size):
    rng = np.random.default_rng(size)
    codes = codec.seq_to_codes(rng.choice(list(b"ACGTN"), size=size - 7).astype(np.uint8).tobytes())
    for g, e in zip(host.pack_for_transfer(codes, size), engine.pack_for_transfer(codes, size)):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("with_owner", [False, True])
@pytest.mark.parametrize("batch", [40, 257])
@pytest.mark.parametrize("name", ["input1", "long"])
def test_iter_packed_batches_matches_engine(name, batch, with_owner):
    data = (FIXTURES.get(name) or _long_fasta()).encode()
    k = 7
    got = host.iter_packed_batches(parse_fastx_bytes(data), k, batch_positions=batch, with_owner=with_owner)
    exp = engine.iter_packed_batches(parse_fastx_bytes(data), k, batch_positions=batch, with_owner=with_owner)
    _assert_batches_equal(got, exp)


@pytest.mark.parametrize("with_owner", [False, True])
@pytest.mark.parametrize("name", sorted(FIXTURES) + ["long"])
def test_stream_file_batches_matches_engine(tmp_path, name, with_owner):
    text = FIXTURES.get(name) or _long_fasta()
    path = write_file(tmp_path / "in.fa.gz", text)
    for k in (3, 21):
        got = host.stream_file_batches(path, k, batch_positions=512, with_owner=with_owner)
        exp = engine.stream_file_batches(path, k, batch_positions=512, with_owner=with_owner)
        _assert_batches_equal(got, exp)


def test_rebatch_and_native_chunks_match_engine(tmp_path):
    path = write_file(tmp_path / "in.fa", _long_fasta(seed=9, n_records=20))
    k = 11
    got_chunks = list(host.stream_native_chunks(path, k, chunk_bytes=4096))
    exp_chunks = list(engine.stream_native_chunks(path, k, chunk_bytes=4096))
    assert len(got_chunks) == len(exp_chunks) > 1
    for (gc, gr, gi), (ec, er, ei) in zip(got_chunks, exp_chunks):
        np.testing.assert_array_equal(gc, ec)
        np.testing.assert_array_equal(gr, er)
        assert gi == ei
    _assert_batches_equal(
        host._rebatch_codes(iter(got_chunks), k, 1000),
        engine._rebatch_codes(iter(exp_chunks), k, 1000),
    )
    codes, rec_ends, ids = got_chunks[0]
    _assert_batches_equal(
        host._iter_batches_from_packed(codes, rec_ends, ids, k, 700, True, 3),
        engine._iter_batches_from_packed(codes, rec_ends, ids, k, 700, True, 3),
    )


def _sorted_unique_run(rng, n, hi=1 << 40):
    v = np.unique(rng.integers(0, hi, size=n, dtype=np.uint64))
    return v, rng.integers(1, 50, size=v.shape[0]).astype(np.int64)


@pytest.mark.parametrize("n_runs", [1, 3, 40])
def test_count_accumulator_matches_engine(n_runs):
    rng = np.random.default_rng(n_runs)
    runs = [_sorted_unique_run(rng, int(rng.integers(0, 5000)), hi=20000) for _ in range(n_runs)]
    got, exp = host.CountAccumulator(), engine.CountAccumulator()
    got.CONSOLIDATE_FLOOR = exp.CONSOLIDATE_FLOOR = 3000
    got._threshold = exp._threshold = 3000
    for v, c in runs:
        got.add(v, c)
        exp.add(v, c)
    for g, e in zip(got.result(), exp.result()):
        np.testing.assert_array_equal(g, e)


def test_merge_sorted_unique_runs_matches_engine():
    rng = np.random.default_rng(3)
    a = _sorted_unique_run(rng, 3000, hi=5000)
    b = _sorted_unique_run(rng, 2000, hi=5000)
    for g, e in zip(
        host._merge_sorted_unique_runs(*a, *b), engine._merge_sorted_unique_runs(*a, *b)
    ):
        np.testing.assert_array_equal(g, e)


def test_prefetch_preserves_items_and_errors():
    assert list(host._prefetch(iter(range(100)), depth=2)) == list(range(100))

    def boom():
        yield 1
        raise ValueError("x")

    with pytest.raises(ValueError):
        list(host._prefetch(boom()))


def test_default_batch(monkeypatch):
    import torch

    monkeypatch.delenv("ORION_KMER_BATCH", raising=False)
    assert host.default_batch(torch.device("cpu")) == 1 << 22
    assert host.default_batch(torch.device("cuda")) == 1 << 24
    monkeypatch.setenv("ORION_KMER_BATCH", "8192")
    assert host.default_batch(torch.device("cuda")) == 8192
