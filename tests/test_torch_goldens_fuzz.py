"""The reference's randomized CLI parity suite (tests/test_fuzz_parity.py:
`count`, `build`, `query`, `classify` and `sketch` against the numpy
oracle) run against the port's CLI on the CPU.

Every case is re-exported.  The autouse fixture points
``tests.util.cli_main`` at the port's ``cli.main`` with ``--device cpu``
in front.  The query, classify and sketch cases force a 640-position
batch through their module's ``_tiny_batch``, which sets the JAX
engine's ``_DEFAULT_BATCH``; the fixture swaps that helper for the
port's knob, ``ORION_KMER_BATCH=640``, so the port's records straddle
batch cuts and halos as the reference's do.  Left out: none.

Tolerance: none, every comparison is of bytes or integers.
"""

import pytest

from orion_kmer_tpu_torch.host import default_batch

from . import test_fuzz_parity, util
from .test_fuzz_parity import (  # noqa: F401  (re-exported cases)
    test_build_cli_fuzz,
    test_classify_cli_fuzz,
    test_count_cli_fuzz,
    test_count_fastq_multiline_fasta_mix,
    test_query_cli_fuzz,
    test_sketch_cli_fuzz,
)
from .test_torch_count import port_cpu


def _port_tiny_batch(monkeypatch):
    """A 640-position batch through every port path that batches."""
    monkeypatch.setenv("ORION_KMER_BATCH", "640")
    assert default_batch("cpu") == 640


@pytest.fixture(autouse=True)
def port_cli(monkeypatch):
    """Every ``run_cli`` of these cases runs the port's CLI on the CPU,
    and ``_tiny_batch`` sets the port's batch."""
    monkeypatch.setattr(util, "cli_main", port_cpu)
    monkeypatch.setattr(test_fuzz_parity, "_tiny_batch", _port_tiny_batch)
