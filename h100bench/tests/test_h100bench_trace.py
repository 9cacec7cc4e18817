"""The union-of-intervals idle share, K1's bound bytes, the tree digest of
a drained pipe, and the check for JAX and the JAX package."""

import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from h100bench.harness import card, digest, peaks, trace
from h100bench.reference import bincode
from h100bench.tests.helpers import ROOT


def Ev(kind, name, start_us, dur_us):
    """One event of a ``torch.profiler`` Chrome trace."""
    return {"ph": "X", "cat": kind, "name": name, "ts": start_us, "dur": dur_us, "pid": 1, "tid": 1}


def test_union_counts_overlaps_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert trace.union(iv, 0, 100) == [(0, 15), (20, 30), (40, 50)]
    assert trace.union(iv, 8, 45) == [(8, 15), (20, 30), (40, 45)]
    assert trace.gaps(trace.union(iv, 0, 60), 0, 60) == [(15, 20), (30, 40), (50, 60)]


def test_summary_of_overlapping_copies_and_kernels():
    events = [
        Ev("user_annotation", trace.WINDOW, 0, 1000),
        Ev("user_annotation", trace.CALL, 0, 500),
        Ev("user_annotation", trace.CALL, 500, 500),
        Ev("cpu_op", "aten::copy_", 100, 50),
        # a copy that a kernel overlaps, and a kernel half outside the window
        Ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 100, 100),
        Ev("kernel", "void (anonymous namespace)::extract_kernel(unsigned int const*, int)", 150, 100),
        Ev("gpu_memset", "Memset (Device)", 600, 10),
        Ev("kernel", "extract_kernel(unsigned int const*, int)", 990, 20),
        Ev("gpu_user_annotation", "h100bench.call", 0, 1000),  # not device work
    ]
    s = trace.Summary(events)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx((150 + 10 + 10) * 1e-6)
    assert s.summed_s == pytest.approx((100 + 100 + 10 + 10) * 1e-6)
    assert s.idle_pct == pytest.approx(83.0)
    t, n = s.kernel_time("extract_kernel")
    assert n == 2 and t == pytest.approx(120e-6)
    assert s.device_ops()[0] == ["extract_kernel", pytest.approx(120e-6)]
    gaps = dict(s.idle_gaps())
    assert gaps["call head: no torch op"] == pytest.approx(100e-6)
    assert gaps["call tail: no torch op"] == pytest.approx(350e-6)
    assert gaps["inside call: no torch op"] == pytest.approx(380e-6)


def test_k1_bound_bytes():
    # 1 Gbp of 150 bp reads at k = 31: 0.25 GB of bases, 8 B a window
    assert peaks.k1_bytes(10**9, 800_000_000) == 250_000_000 + 6_400_000_000
    assert peaks.k1_bytes(5, 2) == 2 + 16
    assert peaks.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert peaks.roofline_pct(1.0, 0.0) is None


@pytest.mark.parametrize("names,bad", [
    (["orion_kmer_tpu_torch", "orion_kmer_tpu_torch.engine", "numpy", "jaxtyping"], []),
    (["orion_kmer_tpu.x", "orion_kmer_tpu_torch"], ["orion_kmer_tpu.x"]),
    (["jax.numpy", "jaxlib", "flax.linen", "torch"], ["flax.linen", "jax.numpy", "jaxlib"]),
    (["orion_kmer_tpu"], ["orion_kmer_tpu"]),
])
def test_forbidden_modules_by_whole_top_level_name(names, bad):
    assert card.forbidden_loaded(names) == bad


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1]);"
        "from h100bench.tests.helpers import run_tiny; from h100bench.harness import card;"
        "r = run_tiny('count-k31'); assert r['correct'], r;"
        "print('forbidden:', card.forbidden_loaded(list(sys.modules)))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "forbidden: []" in out.stdout


def _feed(path, chunks):
    with open(path, "wb") as f:
        for c in chunks:
            f.write(c)


def test_pipe_digest_equals_the_digest_of_the_bytes(tmp_path):
    data = np.random.default_rng(1).integers(0, 256, digest.BLOCK * 2 + 12345, dtype=np.uint8).tobytes()
    with ThreadPoolExecutor(2) as pool:
        sink = digest.PipeSink(tmp_path / "p", digest.consume_stream, pool, digest.buffers())
        try:
            for chunks in ([data], [data[:7], data[7 : digest.BLOCK + 3], data[digest.BLOCK + 3 :]], [b""]):
                t = threading.Thread(target=_feed, args=(sink.path, chunks))
                t.start()
                got = sink.collect(timeout=60)
                t.join()
                assert got.result() == digest.tree_digest(b"".join(chunks), pool)
        finally:
            sink.close()
    assert not os.path.exists(tmp_path / "p")


def test_pipe_reads_a_kmer_database(tmp_path):
    refs = {"a.fa": np.array([1, 5, 2**61], np.uint64), "b.fa": np.arange(3 * 10**6, dtype=np.uint64)}
    bincode.write_db(tmp_path / "x.db", 31, refs)
    blob = (tmp_path / "x.db").read_bytes()
    with ThreadPoolExecutor(2) as pool:
        sink = digest.PipeSink(tmp_path / "p", digest.consume_bincode_db, pool, digest.buffers())
        try:
            for chunks in ([blob], [blob[:-1]], [blob + b"x"]):
                t = threading.Thread(target=_feed, args=(sink.path, chunks))
                t.start()
                got = sink.collect(timeout=60).result()
                t.join()
                if chunks == [blob]:
                    assert got == {"k": 31, "refs": {n: (v.shape[0], digest.tree_digest(v)) for n, v in refs.items()}}
                else:
                    assert got is None  # a malformed stream has no digest
        finally:
            sink.close()
