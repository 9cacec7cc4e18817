"""The port must run without JAX: the machine with the card has none."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import orion_kmer_tpu_torch
from orion_kmer_tpu import codec
from orion_kmer_tpu.ingest.fastx import parse_fastx_bytes

from .util import SAMPLE1_FASTA, write_file

PKG = Path(orion_kmer_tpu_torch.__file__).resolve().parent

SCRIPT = """
import sys
from orion_kmer_tpu_torch.cli import main
rc = main(["count", "-k", "5", "-i", sys.argv[1], "-o", sys.argv[2]])
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(rc, jax_mods)
"""


def test_count_runs_without_importing_jax(tmp_path):
    f = write_file(tmp_path / "a.fa", SAMPLE1_FASTA)
    out = tmp_path / "o.tsv"
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(f), str(out)],
        cwd=PKG.parent,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0 []"
    vals = np.concatenate(
        [codec.extract_kmers_np(codec.seq_to_codes(r.seq), 5) for r in parse_fastx_bytes(SAMPLE1_FASTA.encode())]
    )
    uniq, counts = np.unique(vals, return_counts=True)
    expected = "".join(f"{codec.u64_to_seq(int(v), 5).decode()}\t{c}\n" for v, c in zip(uniq, counts))
    assert out.read_text() == expected


def test_no_jax_import_in_package_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [
        str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())
    ]
    assert offenders == []
