"""The reference's suite of capabilities beyond orion-kmer
(tests/test_cli_extras.py: `count --histogram`, `count`/`build
--checkpoint`, `profile`) run against the port's CLI on the CPU.

Every case is re-exported unchanged except one.  The autouse fixture
points ``tests.util.cli_main`` at the port's ``cli.main`` with
``--device cpu`` in front.

Twinned, on the port's own objects: ``test_threads_flag_sizes_worker_pools``
checks ``-t`` through the reference's ``utils.progress.worker_threads``
and spies on ``orion_kmer_tpu.cohort.find_hybrid.ThreadPoolExecutor``;
its twin reads the port's ``worker_threads`` and spies on
``orion_kmer_tpu_torch.cohort.find_hybrid``.

Tolerance: none, every comparison is of bytes or integers.
"""

import gzip
import json
import os

import pytest

import orion_kmer_tpu_torch.cohort.find_hybrid as fh
from orion_kmer_tpu_torch.utils.progress import worker_threads

from . import util
from .test_cli_extras import (  # noqa: F401  (re-exported cases)
    test_build_checkpoint_resume,
    test_count_checkpoint_k_mismatch_ignored,
    test_count_checkpoint_resume,
    test_count_histogram,
    test_profile_basic,
    test_profile_db_k_mismatch,
    test_profile_with_databases,
)
from .test_torch_count import port_cpu
from .util import run_cli, write_file


@pytest.fixture(autouse=True)
def port_cli(monkeypatch):
    """Every ``run_cli`` of these cases runs the port's CLI on the CPU."""
    monkeypatch.setattr(util, "cli_main", port_cpu)


def test_threads_flag_sizes_worker_pools(tmp_path, monkeypatch):
    """Twin of the reference case: ``-t`` sizes the port's worker pools."""
    monkeypatch.delenv("ORION_KMER_THREADS", raising=False)
    inp = write_file(tmp_path / "x.fasta", ">r\nACGTACGT\n")
    assert run_cli("-t", 3, "count", "-k", 3, "-i", inp, "-o", tmp_path / "o.tsv") == 0
    assert os.environ["ORION_KMER_THREADS"] == "3"
    assert worker_threads() == 3

    seen = {}
    real_tpe = fh.ThreadPoolExecutor

    class SpyTPE(real_tpe):
        def __init__(self, max_workers=None, **kw):
            seen["max_workers"] = max_workers
            super().__init__(max_workers=max_workers, **kw)

    class NullClient:
        def sra_metadata(self, accessions, detailed=True):
            return []

    monkeypatch.setattr(fh, "ThreadPoolExecutor", SpyTPE)
    manifest = tmp_path / "m.json.gz"
    rows = [{"study_accession": "PRJ1", "sample_accession": "S1", "run_accession": "R1",
             "instrument_model": "Illumina HiSeq 2500"}]
    manifest.write_bytes(gzip.compress(json.dumps(rows).encode()))
    fh.find_hybrid_samples(input_file=manifest, output_file=tmp_path / "h.json", client=NullClient())
    assert seen["max_workers"] == 3
