"""The union of a ``KmerDb``'s sets: the K2 merge forest
(``setops.union_runs``, ``engine.union_of_sets``) that a CUDA device runs,
against the numpy stable sort (``db.sorted_unique``) that ``None`` and the
CPU keep.

Here the forest runs on CPU tensors, where ``merge`` takes
``merge_plain``, and on meta tensors under the kernel recorder of
``test_torch_devices.py`` (its launches by caller and size).  On a card it
runs the kernels, against the numpy path and through the CLI.  This file
imports no jax, so the card tests run on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_union.py
"""

import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orion_kmer_tpu_torch import cli, engine
from orion_kmer_tpu_torch.db import KmerDb, sorted_unique
from orion_kmer_tpu_torch.ops import merge, setops
from orion_kmer_tpu_torch.utils import spans

from .test_torch_devices import _meta, recorder  # noqa: F401  (a fixture)

TOP = np.uint64(1 << 63)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pool(rng, n, k=31):
    """n distinct u64 values below 4^k, sorted; at k = 32 half of them at or
    above 2^63, with 2^63 and the all-ones value among them."""
    if k < 32:
        return sorted_unique(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64))
    vals = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    vals[: n // 2] |= TOP
    return sorted_unique(np.concatenate([vals, [TOP, ~np.uint64(0), np.uint64(0)]]))


def _draw(rng, pool, size):
    """A sorted unique set of at most ``size`` values of ``pool``."""
    return sorted_unique(rng.choice(pool, size=min(size, pool.shape[0]), replace=False))


def _sets(case, rng):
    pool = _pool(rng, 5000)
    if case == "none":
        return []
    if case == "one":
        return [_draw(rng, pool, 777)]
    if case == "empty sets mixed in":
        e = np.empty(0, dtype=np.uint64)
        return [e, _draw(rng, pool, 300), e, e, _draw(rng, pool, 301), e]
    if case == "only empty sets":
        return [np.empty(0, dtype=np.uint64)] * 3
    if case == "disjoint":
        return [pool[i::4] for i in range(4)]
    if case == "identical":
        return [pool[:1001]] * 4
    if case == "overlapping":
        return [pool[:3000], pool[1000:4000], pool[2000:], pool[::7]]
    if case.endswith(" runs"):
        return [_draw(rng, pool, int(s)) for s in rng.integers(1, 600, int(case.split()[0]))]
    if case == "k = 32":
        pool = _pool(rng, 4000, k=32)
        return [_draw(rng, pool, 1500) for _ in range(5)] + [pool[-3:], pool[:2]]
    raise ValueError(case)


CASES = ["none", "one", "empty sets mixed in", "only empty sets", "disjoint", "identical", "overlapping",
         "3 runs", "5 runs", "50 runs", "k = 32"]


def _expected(sets):
    return sorted_unique(np.concatenate(sets)) if sets else np.empty(0, dtype=np.uint64)


@pytest.mark.parametrize("case", CASES)
def test_the_forest_on_cpu_tensors_is_the_numpy_union(case):
    sets = _sets(case, np.random.default_rng(CASES.index(case)))
    exp = _expected(sets)
    vals, n = engine.union_of_sets(sets, "cpu")
    assert vals.dtype == np.uint64 and np.array_equal(vals, exp)
    assert n == exp.shape[0]
    assert engine.union_of_sets(sets, "cpu", fetch=False) == (None, exp.shape[0])


def test_each_merge_writes_an_aligned_slice_of_the_other_buffer(monkeypatch):
    """Every K2 output starts at an even offset of the buffer the level
    writes, which is never the buffer its inputs lie in."""
    seen = []

    def recorded(a, b, *, caller, out):
        seen.append((caller, out.storage_offset() % 2, out.untyped_storage().data_ptr(),
                     {a.untyped_storage().data_ptr(), b.untyped_storage().data_ptr()}))
        return merge.merge(a, b, caller=caller, out=out)

    monkeypatch.setattr(setops, "merge", recorded)
    sets = _sets("50 runs", np.random.default_rng(3))
    assert np.array_equal(engine.union_of_sets(sets, "cpu")[0], _expected(sets))
    assert len(seen) == 49
    assert all(caller == "union" and odd == 0 and dst not in srcs for caller, odd, dst, srcs in seen)


def test_the_forest_counts_its_launches_by_caller(recorder, monkeypatch):  # noqa: F811
    """Five non-empty runs take four K2 launches, all under ``union``, by
    merged length; the empty run takes none and the odd runs are copied."""
    monkeypatch.setattr(merge, "launches", 0)
    monkeypatch.setattr(merge, "by_caller", {})
    monkeypatch.setattr(merge, "by_size", {})
    lengths = [8, 0, 5, 16, 3, 7]
    keys, heads = setops.union_runs(_meta(sum(lengths) + len(lengths)), lengths)
    assert keys.shape == heads.shape == (39,)
    assert [name for name, _ in recorder.calls] == ["okt_merge"] * 4
    assert merge.launches == 4
    assert merge.by_caller == {"union": 4}
    assert merge.by_size == {"union ~2^4": 2, "union ~2^5": 2}  # 13, 19; 32, 39


@pytest.fixture
def forest_for_cuda(monkeypatch):
    """``KmerDb`` sees a CUDA device, and ``union_of_sets`` runs on the
    CPU; the calls it gets are listed."""
    calls = []
    real = engine.union_of_sets

    def on_cpu(sets, device, fetch=True):
        calls.append((str(device), fetch))
        return real(sets, "cpu", fetch)

    monkeypatch.setattr(engine, "union_of_sets", on_cpu)
    return calls


def test_a_cuda_device_takes_the_forest_and_none_or_cpu_the_numpy_path(forest_for_cuda):
    sets = _sets("5 runs", np.random.default_rng(5))
    db = KmerDb(k=31, references={f"g{i}": s for i, s in enumerate(sets)})
    exp = _expected(sets)
    for device in (None, "cpu", torch.device("cpu")):
        assert np.array_equal(db.get_all_kmers_unified(device), exp)
        assert db.total_unique_kmers(device) == exp.shape[0]
    assert forest_for_cuda == []
    assert np.array_equal(db.get_all_kmers_unified(torch.device("cuda")), exp)
    assert db.total_unique_kmers("cuda:0") == exp.shape[0]
    assert forest_for_cuda == [("cuda", True), ("cuda:0", False)]
    assert KmerDb(k=31).total_unique_kmers("cuda") == 0 and forest_for_cuda[2:] == []


def test_the_union_span_counts_the_keys_merged(forest_for_cuda):
    sets = _sets("empty sets mixed in", np.random.default_rng(6))
    db = KmerDb(k=31, references={f"g{i}": s for i, s in enumerate(sets)})
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        db.total_unique_kmers("cuda")
        db.get_all_kmers_unified()
    got = [s for s in spans.take().spans if s.name == "db.union"]
    assert [s.counts for s in got] == [{"keys": 601}] * 2
    assert len(forest_for_cuda) == 1


# ---- on the card ---------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 32])
def test_the_union_on_the_card_is_the_numpy_union(cuda, k):
    rng = np.random.default_rng(k)
    pool = _pool(rng, 1 << 21, k)
    sizes = [0, 1, 2, 1 << 20, 3, 0, *rng.integers(1, 1 << 16, 44).tolist(), (1 << 17) + 1]
    db = KmerDb(k=k, references={f"g{i}": _draw(rng, pool, s) for i, s in enumerate(sizes)})
    before = merge.by_caller.get("union", 0)
    exp = db.get_all_kmers_unified()
    got = db.get_all_kmers_unified(cuda)
    assert got.dtype == np.uint64 and np.array_equal(got, exp)
    assert db.total_unique_kmers(cuda) == exp.shape[0]
    assert merge.by_caller["union"] - before == 2 * (len(sizes) - 2 - 1)  # two sets are empty
    one = KmerDb(k=k, references={"a": exp[:5], "b": exp[:0]})
    assert np.array_equal(one.get_all_kmers_unified(cuda), exp[:5]) and one.total_unique_kmers(cuda) == 5


def _genomes(tmp_path, rng):
    """Five 20 kbp genomes, each the first mutated at 0-20 %, and 300
    reads of 120 bp drawn from them."""
    base = rng.integers(0, 4, 20_000)
    paths, seqs = [], []
    for i, rate in enumerate([0.0, 0.01, 0.05, 0.1, 0.2]):
        seq = np.where(rng.random(base.shape[0]) < rate, rng.integers(0, 4, base.shape[0]), base)
        text = "".join("ACGT"[c] for c in seq)
        seqs.append(text)
        paths.append(tmp_path / f"g{i}.fa")
        paths[-1].write_text(f">g{i}\n" + "\n".join(text[j : j + 70] for j in range(0, len(text), 70)) + "\n")
    reads = tmp_path / "reads.fq"
    starts = rng.integers(0, 20_000 - 120, 300)
    reads.write_text("".join(f"@r{j}\n{seqs[j % 5][s : s + 120]}\n+\n{'I' * 120}\n" for j, s in enumerate(starts)))
    return paths, reads


class _Lines(logging.Handler):
    """The messages of the commands' loggers."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        if record.name.rsplit(".", 1)[-1] in ("build", "classify", "compare", "query"):
            self.lines.append(f"{record.name} {record.levelname} {record.getMessage()}")


@pytest.mark.cuda
def test_the_joins_and_build_on_the_card_write_the_cpus_bytes_and_log_lines(cuda, tmp_path):
    paths, reads = _genomes(tmp_path, np.random.default_rng(16))
    db, db2, out = tmp_path / "g.db", tmp_path / "h.db", tmp_path / "out"
    commands = {
        "build": ["build", "-k", 21, "-g", *paths, "-o", db],
        "build 2": ["build", "-k", 21, "-g", *paths[2:], "-o", db2],
        "compare": ["compare", "--db1", db, "--db2", db2, "-o", out],
        "query": ["query", "-d", db, "-r", reads, "-c", 3, "-o", out],
        "classify": ["classify", "-i", reads, "-d", db, db2, "--min-kmer-frequency", 1, "-o", out],
    }
    handler = _Lines()
    logging.getLogger("orion_kmer_tpu_torch").addHandler(handler)
    try:
        got = {}
        for device in ("cpu", "cuda"):
            for name, argv in commands.items():
                handler.lines = []
                assert cli.main(["-v", "--device", device, *argv]) == 0
                written = (db if name == "build" else db2 if name == "build 2" else out).read_bytes()
                got[device, name] = (written, handler.lines)
    finally:
        logging.getLogger("orion_kmer_tpu_torch").removeHandler(handler)
    for name in commands:
        assert got["cuda", name] == got["cpu", name], name
    assert any("total unique canonical k-mers" in line for line in got["cuda", "build"][1])
    assert got["cuda", "query"][0]
