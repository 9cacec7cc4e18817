"""The tail of the port's `count`: the min-count filter, the histogram and
the TSV render in one native pass (``native.render_counts``) spread over
-t threads, the table's fetch (``staging.fetch_table``) and the sharded
and cross-process assembly by a merge of the shards' sorted runs.

Each case holds the fused pass against the path it replaced (the numpy
filter, ``np.unique`` and ``native.counts_tsv_bytes``) and against the
JAX package's ``commands/count.py::write_counts_tsv`` /
``write_histogram`` on the same arrays, byte for byte; gzip's header
time is pinned so compressed outputs compare as bytes too.

Tolerance: none, every comparison is of bytes or integers.
"""

import gzip
import sys
import threading
import types

import numpy as np
import pytest
import torch

from orion_kmer_tpu.cli import main as jax_main
from orion_kmer_tpu.commands import count as jax_count
from orion_kmer_tpu_torch import engine, staging
from orion_kmer_tpu_torch.cli import main as port_main
from orion_kmer_tpu_torch.commands import count as port_count
from orion_kmer_tpu_torch.host import CountAccumulator
from orion_kmer_tpu_torch.ingest import native
from orion_kmer_tpu_torch.ingest.compress import TextOut
from orion_kmer_tpu_torch.keys import keys_from_u64, u64_from_keys
from orion_kmer_tpu_torch.parallel import make_mesh, sharded
from orion_kmer_tpu_torch.parallel.sharded import sharded_count

from .test_torch_count import _random_fasta
from .test_torch_ingest import jax_native_loaded  # noqa: F401  (a fixture)
from .util import write_file

# the JAX writers render through the JAX package's native library
pytestmark = pytest.mark.usefixtures("jax_native_loaded")

K = 31
CAP = native.HIST_CAP


def _table(seed: int, n: int):
    """Sorted unique u64 values with counts: small ones, and some at,
    around and far above the histogram's dense cap."""
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.choice(1 << 62, size=n, replace=False).astype(np.uint64))
    counts = rng.integers(1, 12, size=n).astype(np.int64)
    if n >= 8:
        specials = [CAP - 1, CAP, CAP, CAP + 1, 70_000, 5_000_000_000, 1 << 40, 2]
        counts[rng.choice(n, size=len(specials), replace=False)] = specials
    return vals, counts


def _min_counts(counts):
    """0, 1, 2 and above every count."""
    return {"0": 0, "1": 1, "2": 2, "above": int(counts.max(initial=0)) + 1}


@pytest.fixture
def pinned_gzip_time(monkeypatch):
    """gzip stamps its header with the time: pin it."""
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.0))


def _parent_tail(path, hist, vals, counts, k, min_count):
    """The tail before the fused pass: the histogram by np.unique, the
    numpy filter, then counts_tsv_bytes over the kept rows."""
    with TextOut(hist) as f:
        if counts.shape[0]:
            m, c = np.unique(counts, return_counts=True)
            f.write("".join(f"{a}\t{b}\n" for a, b in zip(m.tolist(), c.tolist())))
    keep = counts >= min_count
    with TextOut(path) as f:
        f.flush()
        if keep.any():
            f.buffer.write(native.counts_tsv_bytes(vals[keep], counts[keep], k))


def _jax_tail(path, hist, vals, counts, k, min_count):
    jax_count.write_histogram(hist, counts)
    keep = counts >= min_count
    jax_count.write_counts_tsv(path, vals[keep], counts[keep], k)


def _three_ways(tmp_path, vals, counts, k, min_count, suffix=""):
    """(port, parent's path, JAX) outputs: each a (TSV bytes, histogram
    bytes) pair, written under the same names in three directories."""
    out = []
    for name, write in (
        ("port", lambda p, h: port_count.write_counts_tsv(p, vals, counts, k, min_count, h)),
        ("parent", lambda p, h: _parent_tail(p, h, vals, counts, k, min_count)),
        ("jax", lambda p, h: _jax_tail(p, h, vals, counts, k, min_count)),
    ):
        d = tmp_path / name
        d.mkdir()
        write(d / f"out.tsv{suffix}", d / f"h.txt{suffix}")
        out.append(((d / f"out.tsv{suffix}").read_bytes(), (d / f"h.txt{suffix}").read_bytes()))
    return out


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
@pytest.mark.parametrize("min_count", ["0", "1", "2", "above"])
def test_fused_pass_matches_the_parent_and_jax(tmp_path, monkeypatch, min_count, threads):
    """Hundreds of chunks (7 rows each) on 1, 2, 3 and 8 threads."""
    vals, counts = _table(threads, 3000)
    monkeypatch.setattr(native, "RENDER_ROWS", 7)
    monkeypatch.setenv("ORION_KMER_THREADS", str(threads))
    port, parent, jax = _three_ways(tmp_path, vals, counts, K, _min_counts(counts)[min_count])
    assert port == parent == jax
    if min_count == "above":
        assert port[0] == b""
    assert port[1].count(b"\n") == np.unique(counts).shape[0]


@pytest.mark.parametrize("suffix", ["", ".gz", ".zst"])
@pytest.mark.parametrize("threads", [1, 3])
def test_compressed_outputs_keep_their_bytes(tmp_path, monkeypatch, pinned_gzip_time, suffix, threads):
    vals, counts = _table(7, 20_000)
    monkeypatch.setattr(native, "RENDER_ROWS", 1000)
    monkeypatch.setenv("ORION_KMER_THREADS", str(threads))
    port, parent, jax = _three_ways(tmp_path, vals, counts, K, 2, suffix)
    assert port == parent == jax


@pytest.mark.parametrize("k", [1, 16, 21, 32])
def test_every_k_renders_like_the_parent(tmp_path, monkeypatch, k):
    rng = np.random.default_rng(k)
    vals = np.unique(rng.integers(0, 1 << min(2 * k, 63), size=5000, dtype=np.uint64))
    counts = rng.integers(1, 4, size=vals.shape[0]).astype(np.int64)
    monkeypatch.setattr(native, "RENDER_ROWS", 333)
    monkeypatch.setenv("ORION_KMER_THREADS", "3")
    port, parent, jax = _three_ways(tmp_path, vals, counts, k, 2)
    assert port == parent == jax


@pytest.mark.parametrize("threads", [1, 4])
def test_zero_rows(tmp_path, monkeypatch, threads):
    monkeypatch.setenv("ORION_KMER_THREADS", str(threads))
    port, parent, jax = _three_ways(tmp_path, np.empty(0, np.uint64), np.empty(0, np.int64), K, 2)
    assert port == parent == jax == (b"", b"")


@pytest.mark.parametrize("threads", [1, 3])
def test_histogram_past_its_cap(threads):
    """Every row above the dense cap (and one at it): the overflow fold
    alone gives the histogram."""
    vals = np.arange(5000, dtype=np.uint64)
    counts = np.full(5000, CAP + 7, np.int64)
    counts[::3] = CAP
    counts[::5] = 1 << 50
    native.RENDER_ROWS, saved = 64, native.RENDER_ROWS
    try:
        got = native.render_counts(lambda b: None, vals, counts, K, 2, True, threads)
    finally:
        native.RENDER_ROWS = saved
    m, c = np.unique(counts, return_counts=True)
    assert np.array_equal(got[0], m) and np.array_equal(got[1], c)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("bad", [0, -4])
def test_a_kept_nonpositive_count_raises(tmp_path, monkeypatch, threads, bad):
    """A count <= 0 raises where the parent's filter-then-render path
    raised: on a kept row only.  The histogram, taken before the filter,
    is written whole either way."""
    vals, counts = _table(3, 2000)
    counts[1234] = bad
    monkeypatch.setattr(native, "RENDER_ROWS", 50)
    monkeypatch.setenv("ORION_KMER_THREADS", str(threads))
    want_hist = tmp_path / "want.txt"
    jax_count.write_histogram(want_hist, counts)
    for min_count in (bad, None):
        with pytest.raises(native.NativeParseError, match="non-positive count"):
            port_count.write_counts_tsv(tmp_path / "o.tsv", vals, counts, K, min_count, tmp_path / "h.txt")
        assert (tmp_path / "h.txt").read_bytes() == want_hist.read_bytes()
    # filtered out: no error, and the row still counts in the histogram
    port, parent, jax = _three_ways(tmp_path, vals, counts, K, 1)
    assert port == parent == jax
    assert f"{bad}\t1\n".encode() in port[1]


def test_the_histogram_is_whole_when_the_tsv_cannot_be_created(tmp_path):
    vals, counts = _table(4, 500)
    with pytest.raises(Exception, match="Failed to create output file"):
        port_count.write_counts_tsv(tmp_path / "no" / "o.tsv", vals, counts, K, 2, tmp_path / "h.txt")
    jax_count.write_histogram(tmp_path / "want.txt", counts)
    assert (tmp_path / "h.txt").read_bytes() == (tmp_path / "want.txt").read_bytes()


def test_without_the_native_library_the_python_path_writes_the_same(tmp_path, monkeypatch):
    vals, counts = _table(5, 4000)
    port_count.write_counts_tsv(tmp_path / "n.tsv", vals, counts, K, 2, tmp_path / "n.txt")
    monkeypatch.setattr(native, "available", lambda: False)
    port_count.write_counts_tsv(tmp_path / "p.tsv", vals, counts, K, 2, tmp_path / "p.txt")
    assert (tmp_path / "n.tsv").read_bytes() == (tmp_path / "p.tsv").read_bytes()
    assert (tmp_path / "n.txt").read_bytes() == (tmp_path / "p.txt").read_bytes()


def test_one_thread_renders_inline(monkeypatch):
    """-t 1 starts no render pool."""
    import concurrent.futures

    def no_pool(*a, **kw):
        raise AssertionError("a render pool at -t 1")

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", no_pool)
    monkeypatch.setattr(native, "RENDER_ROWS", 10)
    vals, counts = _table(6, 1000)
    got = []
    native.render_counts(lambda b: got.append(bytes(b)), vals, counts, K, 2, False, 1)
    keep = counts >= 2
    assert b"".join(got) == bytes(native.counts_tsv_bytes(vals[keep], counts[keep], K))


def test_a_failed_write_stops_the_pool():
    """An error of the output stream propagates, and no render thread
    outlives the call."""
    vals, counts = _table(8, 3000)
    calls = []

    def write(b):
        calls.append(len(b))
        if len(calls) == 3:
            raise OSError("disk full")

    native.RENDER_ROWS, saved = 20, native.RENDER_ROWS
    try:
        with pytest.raises(OSError, match="disk full"):
            native.render_counts(write, vals, counts, K, 1, True, 4)
    finally:
        native.RENDER_ROWS = saved
    assert len(calls) == 3
    assert not [t for t in threading.enumerate() if t.name.startswith("okt-render")]


def test_render_threads_under_stress(monkeypatch):
    """More render threads than cores, a switch interval of a microsecond
    and thousands of 3-row chunks: a buffer rendered into again before it
    was written, or a chunk written out of order, changes the bytes; a
    histogram update lost between threads changes the histogram."""
    vals, counts = _table(9, 20_000)
    monkeypatch.setattr(native, "RENDER_ROWS", 3)
    monkeypatch.setattr(native, "MAX_RENDER_THREADS", 32)
    keep = counts >= 2
    want = bytes(native.counts_tsv_bytes(vals[keep], counts[keep], K))
    m, c = np.unique(counts, return_counts=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            got = []
            hist = native.render_counts(lambda b: got.append(bytes(b)), vals, counts, K, 2, True, 32)
            assert b"".join(got) == want
            assert np.array_equal(hist[0], m) and np.array_equal(hist[1], c)
    finally:
        sys.setswitchinterval(interval)


def test_render_counts_rejects_mismatched_lengths():
    with pytest.raises(ValueError):
        native.render_counts(lambda b: None, np.zeros(3, np.uint64), np.ones(2, np.int64), K)


# ----------------------------------------------------------- the CLI


def _cli_both(tmp_path, *argv_of):
    """Each argv of ``argv_of(out_dir)`` in turn through the JAX CLI and
    the port's (on the CPU); returns each side's outputs but checkpoints."""
    outs = []
    for name, main in (("jax", jax_main), ("port", lambda a: port_main(["--device", "cpu", *a]))):
        d = tmp_path / name
        d.mkdir()
        for argv in argv_of:
            assert main([str(x) for x in argv(d)]) == 0
        outs.append({p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.suffix != ".npz"})
    return outs


@pytest.mark.parametrize("threads", [1, 3])
def test_cli_count_multi_file_matches_jax(tmp_path, monkeypatch, threads):
    text = _random_fasta(31, 3, 3000)
    f1 = write_file(tmp_path / "a.fa.gz", text)
    f2 = write_file(tmp_path / "b.fa", _random_fasta(32, 2, 2000) + text)
    monkeypatch.setattr(native, "RENDER_ROWS", 100)
    monkeypatch.setenv("ORION_KMER_THREADS", "0")  # restored after the CLI's -t export
    jax, port = _cli_both(
        tmp_path,
        lambda d: ["-t", threads, "count", "-k", 21, "-m", 2, "--histogram", d / "h.txt",
                   "-i", f1, f2, "-o", d / "out.tsv"],
    )
    assert jax == port and jax["out.tsv"] and jax["h.txt"]


@pytest.mark.parametrize("threads", [1, 3])
def test_cli_count_checkpointed_matches_jax(tmp_path, monkeypatch, threads):
    """The first file counted into a checkpoint, then both files: the
    first is skipped and its table is the resumed state."""
    f1 = write_file(tmp_path / "a.fa", _random_fasta(5, 3, 2500))
    f2 = write_file(tmp_path / "b.fa", _random_fasta(6, 3, 2500) + _random_fasta(5, 1, 2500))
    monkeypatch.setattr(native, "RENDER_ROWS", 100)
    monkeypatch.setenv("ORION_KMER_THREADS", "0")

    def argv(*files):
        return lambda d: ["-t", threads, "count", "-k", 21, "-m", 2, "--histogram", d / "h.txt",
                          "-i", *files, "-o", d / "out.tsv", "--checkpoint", d / "ck.npz"]

    jax, port = _cli_both(tmp_path, argv(f1), argv(f1, f2))
    assert jax == port and jax["out.tsv"] and jax["h.txt"]


# ------------------------------------------------ fetch and assembly


def test_fetch_table_on_cpu_tensors():
    rng = np.random.default_rng(11)
    vals = np.sort(rng.integers(0, 1 << 64, size=5000, dtype=np.uint64))
    vals[-1] = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
    keys = keys_from_u64(vals)
    counts = torch.from_numpy(rng.integers(1, 100, size=5000).astype(np.int64))
    got_v, got_c = staging.fetch_table(keys, counts)
    assert got_v.dtype == np.uint64 and got_c.dtype == np.int64
    assert np.array_equal(got_v, u64_from_keys(keys)) and np.array_equal(got_v, vals)
    assert np.array_equal(got_c, counts.cpu().numpy())
    empty = staging.fetch_table(keys[:0], counts[:0])
    assert empty[0].shape == empty[1].shape == (0,)


def test_fetch_table_rejects_other_devices():
    x = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        staging.fetch_table(x, x)


def _disjoint_parts(seed, n_parts, n):
    """Sorted runs of keys with counts, disjoint between runs."""
    rng = np.random.default_rng(seed)
    vals = rng.choice(1 << 62, size=n, replace=False).astype(np.uint64)
    owner = rng.integers(0, n_parts, size=n)
    counts = rng.integers(1, 50, size=n).astype(np.int64)
    parts = []
    for s in range(n_parts):
        order = np.argsort(vals[owner == s])
        parts.append((keys_from_u64(vals[owner == s][order]), torch.from_numpy(counts[owner == s][order])))
    return parts


def _argsort_assembly(parts):
    """The assembly before the merge: concatenate, argsort, gather."""
    vals = np.concatenate([u64_from_keys(k) for k, _ in parts])
    counts = np.concatenate([c.numpy() for _, c in parts])
    order = np.argsort(vals, kind="stable")
    return vals[order], counts[order]


@pytest.mark.parametrize("native_ok", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2, 4, native.MAX_KWAY, native.MAX_KWAY + 1, 40])
def test_assembly_merges_like_the_argsort(monkeypatch, n_parts, native_ok):
    """Above MAX_KWAY runs, or without the native library, the merge is
    numpy's."""
    parts = _disjoint_parts(n_parts, n_parts, 3000)
    parts[0] = (parts[0][0][:0], parts[0][1][:0])  # an empty shard
    want = _argsort_assembly(parts)
    if not native_ok:
        monkeypatch.setattr(native, "available", lambda: False)
    got = sharded._assemble(parts)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_count_matches_one_table(n_shards):
    rng = np.random.default_rng(n_shards)
    codes = rng.integers(0, 4, size=50_000, dtype=np.uint8)
    codes[rng.random(50_000) < 0.01] = 255
    invalid = codes > 3
    got = sharded_count(codes, invalid, 21, make_mesh(n_shards, "cpu"))
    table = engine.DeviceCountTable(21, "cpu")
    table.update(codes)
    want = table.result()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_accumulator_keeps_int64_counts_without_a_copy():
    vals = np.arange(10, dtype=np.uint64)
    counts = np.arange(1, 11, dtype=np.int64)
    acc = CountAccumulator()
    acc.add(vals, counts)
    got = acc.result()
    assert got[1] is counts  # one run: handed back as it came
    acc = CountAccumulator()
    acc.add(vals, counts.astype(np.int32))
    assert acc.result()[1].dtype == np.int64
