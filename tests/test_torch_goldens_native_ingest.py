"""The reference's native-ingest suite (tests/test_native_ingest.py) run
against the port's parser (``orion_kmer_tpu_torch/ingest/native.py``) and
host accumulator (``host.py``) on the CPU.

Re-exported unchanged, with every parameter case: the autouse fixture
points the name ``native`` of that module, and the attribute
``orion_kmer_tpu.ingest.native`` that its cases import inside their
bodies, at the port's module, so each case parses, packs, merges and
renders through the port.  The reference's Python parser and codec stay
the oracle.

Twinned, on the port's own objects: ``test_count_accumulator_native_vs_fallback``
(the reference case builds ``orion_kmer_tpu.engine.CountAccumulator``,
whose merges go through the JAX package's parser module; the twin builds
``host.CountAccumulator``) and ``test_counts_tsv_native_matches_python``
(the twin writes through the port's ``commands.count.write_counts_tsv``).

Tolerance: none, every comparison is of bytes or integers.
"""

import numpy as np
import pytest

import orion_kmer_tpu.ingest as jax_ingest
from orion_kmer_tpu_torch import host
from orion_kmer_tpu_torch.ingest import native as port_native

from . import test_native_ingest as ref
from .test_native_ingest import (  # noqa: F401  (re-exported cases)
    test_counts_tsv_rejects_nonpositive_count,
    test_merge_unique_kway_matches_oracle,
    test_merge_unique_matches_oracle,
    test_native_crlf,
    test_native_empty_errors,
    test_native_headers_only_fasta,
    test_native_large_random_roundtrip,
    test_native_malformed_fastq,
    test_native_matches_python,
    test_native_u_normalization,
    test_native_unknown_format,
    test_pack_wire_matches_numpy_path,
)


@pytest.fixture(autouse=True)
def port_parser(monkeypatch):
    """Every case of these reaches the port's ``ingest/native.py``."""
    assert port_native.available()
    monkeypatch.setattr(ref, "native", port_native)
    monkeypatch.setattr(jax_ingest, "native", port_native)


def test_cases_reach_the_port():
    from orion_kmer_tpu.ingest import native

    assert native is port_native and ref.native is port_native


def test_count_accumulator_native_vs_fallback(monkeypatch):
    """Twin of the reference case on ``host.CountAccumulator``: the native
    k-way path and the numpy pairwise fallback agree exactly."""
    rng = np.random.default_rng(15)
    runs = []
    base = np.unique(rng.integers(0, 5000, size=3000, dtype=np.uint64))
    for _ in range(6):
        v = np.unique(
            np.concatenate(
                [
                    rng.choice(base, size=800, replace=False),
                    rng.integers(0, 1 << 62, size=500, dtype=np.uint64),
                ]
            )
        )
        runs.append((v, rng.integers(1, 9, size=v.shape[0]).astype(np.int64)))

    def feed():
        acc = host.CountAccumulator()
        for v, c in runs:
            acc.add(v, c)
        return acc.result()

    v_native, c_native = feed()
    monkeypatch.setattr(port_native, "available", lambda: False)
    v_np, c_np = feed()
    np.testing.assert_array_equal(v_native, v_np)
    np.testing.assert_array_equal(c_native, c_np)


def test_counts_tsv_native_matches_python(tmp_path, monkeypatch):
    """Twin of the reference case on the port's ``write_counts_tsv``: the
    native renderer is byte-identical to the Python path across k
    extremes and count magnitudes."""
    from orion_kmer_tpu_torch.commands.count import write_counts_tsv

    rng = np.random.default_rng(21)
    for k in (1, 21, 32):
        n = 3000
        vals = np.sort(rng.integers(0, 1 << min(2 * k, 63), size=n, dtype=np.uint64))
        counts = np.concatenate(
            [rng.integers(1, 10, size=n - 3), np.array([255, 70000, 5_000_000_000])]
        ).astype(np.int64)
        pn = tmp_path / f"n{k}.tsv"
        pp = tmp_path / f"p{k}.tsv"
        write_counts_tsv(pn, vals, counts, k)
        with monkeypatch.context() as m:
            m.setattr(port_native, "available", lambda: False)
            write_counts_tsv(pp, vals, counts, k)
        assert pn.read_bytes() == pp.read_bytes()
