"""The reference's `build` golden suite (tests/test_cli_build.py, after
orion-kmer's build_tests.rs) run against the port's CLI on the CPU.

The 14 CLI cases are re-exported unchanged: the autouse fixture points
``tests.util.cli_main`` at the port's ``cli.main`` with ``--device cpu``
in front, and the cases read the written databases with the reference's
``orion_kmer_tpu.db.KmerDb``, a cross-check of the file format.

Twinned: the four database-model cases (``test_db_bincode_roundtrip``,
``test_db_bincode_layout``, ``test_db_add_reference_overwrites``,
``test_db_bincode_layout_multi_ref``) run no CLI; they exercise the
reference's ``KmerDb`` itself.  ``test_port_db_model`` runs each of them
with the port's ``orion_kmer_tpu_torch.db.KmerDb`` in its place.

Tolerance: none, every comparison is of bytes or integers.
"""

import inspect

import pytest

from orion_kmer_tpu_torch.db import KmerDb as PortKmerDb

from . import test_cli_build, util
from .test_cli_build import (  # noqa: F401  (re-exported cases)
    test_build_0_byte_empty_file,
    test_build_duplicate_kmers_k4,
    test_build_fasta_with_no_sequences,
    test_build_file_not_found,
    test_build_gz_output,
    test_build_input1_compression_matrix_k7,
    test_build_invalid_k,
    test_build_malformed_fasta,
    test_build_multiple_compressed_inputs_k5,
    test_build_multiple_files_k4,
    test_build_simple_fasta_k3,
)
from .test_torch_count import port_cpu


@pytest.fixture(autouse=True)
def port_cli(monkeypatch):
    """Every ``run_cli`` of these cases runs the port's CLI on the CPU."""
    monkeypatch.setattr(util, "cli_main", port_cpu)


DB_MODEL_CASES = [
    test_cli_build.test_db_bincode_roundtrip,
    test_cli_build.test_db_bincode_layout,
    test_cli_build.test_db_add_reference_overwrites,
    test_cli_build.test_db_bincode_layout_multi_ref,
]


@pytest.mark.parametrize("case", DB_MODEL_CASES, ids=lambda case: case.__name__)
def test_port_db_model(case, monkeypatch, tmp_path):
    """The reference's database-model case with the port's ``KmerDb``."""
    monkeypatch.setattr(test_cli_build, "KmerDb", PortKmerDb)
    case(*[tmp_path for _ in inspect.signature(case).parameters])
