"""The reference's `compare`, `query` and `classify` golden suites
(tests/test_cli_{compare,query,classify}.py, after orion-kmer's
compare_tests.rs, query_tests.rs and classify_tests.rs) run against the
port's CLI on the CPU.

Every case is re-exported unchanged except two of classify's, which patch
the JAX package's internals and would test nothing of the port.  The
autouse fixture points ``tests.util.cli_main`` at the port's ``cli.main``
with ``--device cpu`` in front; the databases the cases build are written
by the port.

Twinned, on the port's own objects:
  * ``test_classify_single_dispatch_per_db`` counts calls of
    ``orion_kmer_tpu.ops.setops.classify_join``; its twin counts the
    port's ``orion_kmer_tpu_torch.ops.setops.classify_join``;
  * ``test_classify_chunked_joins_match_single`` lowers the reference's
    ``ClassifyJoiner.MAX_JOIN``; its twin lowers the port's
    ``orion_kmer_tpu_torch.engine.ClassifyJoiner.MAX_JOIN``.

Tolerance: as the re-exported cases state (1e-6 on ratios printed as
floats); the twins compare integers and bytes.
"""

import numpy as np
import pytest

from orion_kmer_tpu_torch.engine import ClassifyJoiner
from orion_kmer_tpu_torch.ops import setops

from . import util
from .test_cli_classify import (  # noqa: F401  (re-exported cases)
    test_classify_basic_fasta_input,
    test_classify_k_mismatch_between_databases,
    test_classify_k_validation_error,
    test_classify_min_coverage_filter,
    test_classify_min_kmer_frequency_filter,
    test_classify_output_tsv,
    test_classify_references_sorted,
)
from .test_cli_compare import (  # noqa: F401  (re-exported cases)
    test_compare_basic,
    test_compare_corrupt_db,
    test_compare_db_not_found,
    test_compare_empty_union_jaccard_zero,
    test_compare_identical_databases,
    test_compare_kmer_size_mismatch,
    test_compare_partial_overlap,
)
from .test_cli_query import (  # noqa: F401  (re-exported cases)
    test_query_basic_matches,
    test_query_db_file_not_found,
    test_query_empty_reads_file,
    test_query_gz_reads_and_output,
    test_query_min_hits_filter,
    test_query_output_preserves_input_order,
    test_query_raw_bytes_not_normalized,
    test_query_reads_file_not_found,
)
from .test_torch_count import port_cpu
from .util import run_cli, write_file


@pytest.fixture(autouse=True)
def port_cli(monkeypatch):
    """Every ``run_cli`` of these cases runs the port's CLI on the CPU."""
    monkeypatch.setattr(util, "cli_main", port_cpu)


def _random_genomes(tmp_path, rng, n, length, prefix):
    return [
        write_file(tmp_path / f"{prefix}{i}.fasta", f">{prefix}{i}\n{''.join(rng.choice(list('ACGT'), size=length))}\n")
        for i in range(n)
    ]


def test_classify_single_dispatch_per_db(tmp_path, monkeypatch):
    """Twin of the reference case: one join per database (all references
    concatenated), not one per reference."""
    calls = {"n": 0}
    orig = setops.classify_join

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(setops, "classify_join", counting)
    rng = np.random.default_rng(3)
    genomes = _random_genomes(tmp_path, rng, 6, 400, "g")
    db = tmp_path / "many.db"
    assert run_cli("build", "-k", 11, "-g", *genomes, "-o", db) == 0
    inp = write_file(tmp_path / "in.fasta", ">r\n" + "".join(rng.choice(list("ACGT"), size=600)) + "\n")
    calls["n"] = 0
    assert run_cli("classify", "-i", inp, "-d", db, "-o", tmp_path / "out.json") == 0
    assert calls["n"] == 1, f"expected 1 join dispatch for 6 refs, got {calls['n']}"


def test_classify_chunked_joins_match_single(tmp_path, monkeypatch):
    """Twin of the reference case: a database past MAX_JOIN is joined in
    chunks at reference boundaries, with the same output bytes."""
    rng = np.random.default_rng(8)
    genomes = _random_genomes(tmp_path, rng, 5, 300, "c")
    db = tmp_path / "c.db"
    assert run_cli("build", "-k", 9, "-g", *genomes, "-o", db) == 0
    inp = write_file(tmp_path / "in.fasta", ">r\n" + "".join(rng.choice(list("ACGT"), size=500)) + "\n")
    calls = {"n": 0}
    orig = setops.classify_join

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(setops, "classify_join", counting)
    o1, o2 = tmp_path / "one.json", tmp_path / "many.json"
    assert run_cli("classify", "-i", inp, "-d", db, "-o", o1) == 0
    assert calls["n"] == 1
    monkeypatch.setattr(ClassifyJoiner, "MAX_JOIN", 400)  # ~4 chunks
    assert run_cli("classify", "-i", inp, "-d", db, "-o", o2) == 0
    assert calls["n"] > 2, "the lowered bound split the join"
    assert o1.read_text() == o2.read_text()
