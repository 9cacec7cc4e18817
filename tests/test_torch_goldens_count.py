"""The reference's `count` golden suite (tests/test_cli_count.py, after
orion-kmer's count_tests.rs) run against the port's CLI on the CPU.

Every case of tests/test_cli_count.py is re-exported unchanged.  The
autouse fixture points ``tests.util.cli_main``, which ``run_cli`` looks up
at call time, at the port's ``cli.main`` with ``--device cpu`` in front.
Left out or twinned: none.

Tolerance: none, every comparison is of bytes or integers.
"""

import pytest

from . import util
from .test_cli_count import (  # noqa: F401  (re-exported cases)
    test_count_empty_input_file,
    test_count_fastq_k4,
    test_count_file_not_found,
    test_count_gz_output,
    test_count_input1_compression_matrix_k7,
    test_count_input2_compression_matrix_k6,
    test_count_invalid_k_too_large,
    test_count_invalid_k_zero,
    test_count_multiple_compressed_inputs_k5,
    test_count_multiple_files_k5_mincount2,
    test_count_no_matching_kmers_high_mincount,
    test_count_output_sorted_ascending,
    test_count_simple_fasta_k3,
)
from .test_torch_count import port_cpu


@pytest.fixture(autouse=True)
def port_cli(monkeypatch):
    """Every ``run_cli`` of these cases runs the port's CLI on the CPU."""
    monkeypatch.setattr(util, "cli_main", port_cpu)
