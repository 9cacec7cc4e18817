"""``KmerDb.save`` streams the bincode piece by piece: the bytes it writes
equal ``to_bincode()``'s for a plain file, and decompress to them for
``.gz``, ``.xz`` and ``.zst``; ``load`` gives back the same model; and no
whole-file buffer is built on the way.  This file imports no jax."""

import gzip
import lzma
import tracemalloc

import numpy as np
import pytest
import zstandard

from orion_kmer_tpu_torch.db import KmerDb


def _db(case: str) -> KmerDb:
    rng = np.random.default_rng(19)
    db = KmerDb(k=31)
    if case == "many":
        for i, n in enumerate((5, 1, 3000)):
            db.add_reference(f"ref{i}.fa", rng.integers(0, 1 << 62, n, dtype=np.uint64))
    elif case == "empty_set":
        db.add_reference("a.fa", rng.integers(0, 1 << 62, 40, dtype=np.uint64))
        db.add_reference("empty.fa", np.empty(0, dtype=np.uint64))
        db.add_reference("b.fa", np.array([0, (1 << 62) - 1], dtype=np.uint64))
    elif case == "non_ascii":
        db.add_reference("génome_Ω_菌.fa", rng.integers(0, 1 << 62, 100, dtype=np.uint64))
        db.add_reference("", np.array([7], dtype=np.uint64))
    else:
        assert case == "no_reference"
    return db


_DECOMPRESS = {
    "": lambda b: b,
    ".gz": gzip.decompress,
    ".xz": lzma.decompress,
    ".zst": lambda b: zstandard.ZstdDecompressor().decompressobj().decompress(b),
}


@pytest.mark.parametrize("case", ["many", "empty_set", "non_ascii", "no_reference"])
@pytest.mark.parametrize("ext", list(_DECOMPRESS))
def test_save_writes_the_bincode_and_load_reads_it_back(tmp_path, case, ext):
    db = _db(case)
    path = tmp_path / f"db{ext}"
    db.save(path)
    raw = path.read_bytes()
    assert (raw == db.to_bincode()) == (ext == "")
    assert _DECOMPRESS[ext](raw) == db.to_bincode()
    back = KmerDb.load(path)
    assert back.k == db.k and list(back.references) == list(db.references)
    for name, kmers in db.references.items():
        assert back.references[name].dtype == np.uint64
        np.testing.assert_array_equal(back.references[name], kmers)


def test_save_builds_no_whole_file_buffer(tmp_path):
    """Under ``tracemalloc`` (numpy's buffers are traced), the save of four
    sets of 2^20 keys (a 32 MiB file) peaks below one set's 8 MiB: each
    set is written from its own array.  Building the file in memory first
    peaks at twice the file or more."""
    rng = np.random.default_rng(7)
    db = KmerDb(k=31)
    for i in range(4):
        db.add_reference(f"g{i}.fa", rng.integers(0, 1 << 62, 1 << 20, dtype=np.uint64))
    one_set = max(s.nbytes for s in db.references.values())
    path = tmp_path / "big.db"
    tracemalloc.start()
    try:
        db.save(path)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert path.stat().st_size == 9 + sum(16 + len(n) + s.nbytes for n, s in db.references.items())
    assert peak < one_set + (1 << 20)
