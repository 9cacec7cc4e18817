"""The port must run without JAX and without the JAX package: the machine
with the card has no JAX, and the port keeps its own copies of what it
needs.  It runs on the card unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import orion_kmer_tpu_torch
from orion_kmer_tpu_torch import cli, codec
from orion_kmer_tpu_torch.commands import count
from orion_kmer_tpu_torch.ingest.fastx import parse_fastx_bytes

from .util import SAMPLE1_FASTA, SAMPLE2_FASTQ, write_file

PKG = Path(orion_kmer_tpu_torch.__file__).resolve().parent

SCRIPT = """
import json, os, sys, threading
from orion_kmer_tpu_torch import server
from orion_kmer_tpu_torch.cli import main
from orion_kmer_tpu_torch.commands import cohort

class Client:  # offline metadata client for cohort summarize
    def sra_metadata(self, accessions, detailed=True):
        return [{"biosample": "B1", "organism_name": "gut", "instrument_model": "MinION"}]

cohort.make_client = Client
fa, fq, d = sys.argv[1:]
with open(d + "/m.json", "w") as f:
    json.dump([{"sample": "S", "files": [fa, fq]}], f)
with open(d + "/hyb.json", "w") as f:
    json.dump([{"biosample": "B1"}], f)
runs = [
    ["count", "-k", "5", "-i", fa, "-o", d + "/o.tsv"],
    ["build", "-k", "5", "-g", fa, fq, "-o", d + "/db.db"],
    ["compare", "--db1", d + "/db.db", "--db2", d + "/db.db", "-o", d + "/cmp.json"],
    ["query", "-d", d + "/db.db", "-r", fq, "-o", d + "/ids.txt"],
    ["classify", "-i", fa, "-d", d + "/db.db", "-o", d + "/cl.json", "--output-tsv", d + "/cl.tsv"],
    ["sketch", "-k", "5", "--scaled", "2", "-i", fa, fq, "-o", d + "/s.sig"],
    ["sketch-compare", "-s", d + "/s.sig", "-o", d + "/sc.json"],
    ["profile", "-k", "5", "--manifest", d + "/m.json", "-d", d + "/db.db", "--scaled", "2", "-o", d + "/p.json"],
    ["cohort", "summarize", "-i", d + "/hyb.json", "-o", d + "/sum.tsv"],
]
rcs = [main(["--device", "cpu", *argv]) for argv in runs]
os.environ["ORION_KMER_SHARDS"] = "4"  # the same count over four CPU shards
rcs.append(main(["--device", "cpu", "count", "-k", "5", "-i", fa, "-o", d + "/sharded.tsv"]))
del os.environ["ORION_KMER_SHARDS"]
ready = threading.Event()
t = threading.Thread(target=server.serve, args=(d + "/s.sock", "cpu"), kwargs={"on_ready": ready.set})
t.start()
ready.wait(60)
rcs.append(main(["--server", d + "/s.sock", "count", "-k", "5", "-i", fa, "-o", d + "/served.tsv"]))
main(["--server", d + "/s.sock", "shutdown"])
t.join(60)
banned = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "orion_kmer_tpu" or m.startswith("orion_kmer_tpu.")
)
print(rcs, banned, "orion_kmer_tpu_torch.parallel.streaming" in sys.modules)
"""

OUTPUTS = ("db.db", "cmp.json", "ids.txt", "cl.json", "cl.tsv", "s.sig", "sc.json", "p.json", "sum.tsv")


def test_every_subcommand_runs_without_jax_or_the_jax_package(tmp_path):
    fa = write_file(tmp_path / "a.fa", SAMPLE1_FASTA)
    fq = write_file(tmp_path / "b.fq", SAMPLE2_FASTQ)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(fa), str(fq), str(tmp_path)],
        cwd=PKG.parent,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0] [] True"
    vals = np.concatenate(
        [codec.extract_kmers_np(codec.seq_to_codes(r.seq), 5) for r in parse_fastx_bytes(SAMPLE1_FASTA.encode())]
    )
    uniq, counts = np.unique(vals, return_counts=True)
    expected = "".join(f"{codec.u64_to_seq(int(v), 5).decode()}\t{c}\n" for v, c in zip(uniq, counts))
    assert (tmp_path / "o.tsv").read_text() == expected
    assert (tmp_path / "served.tsv").read_text() == expected
    assert (tmp_path / "sharded.tsv").read_text() == expected
    for name in OUTPUTS:
        assert (tmp_path / name).exists(), name
    assert not (tmp_path / "s.sock").exists()


def test_no_jax_or_jax_package_import_in_sources():
    pattern = re.compile(r"^\s*(import jax|from jax|import orion_kmer_tpu\b(?!_torch)|from orion_kmer_tpu\b(?!_torch))", re.M)
    sources = [*PKG.rglob("*.py"), PKG.parent / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    names = {str(p.relative_to(PKG)) for p in sources if PKG in p.parents}
    new_modules = {"server.py", "ops/hash.py", "ops/sketch.py", "commands/sketch.py", "commands/profile.py",
                   "commands/cohort.py", *(f"cohort/{m}.py" for m in
                                           ("__init__", "client", "entrez", "find_hybrid", "manifest",
                                            "platforms", "summarize")),
                   *(f"parallel/{m}.py" for m in ("__init__", "mesh", "sharded", "streaming", "distributed"))}
    assert new_modules <= names
    assert len(sources) > 30


def test_default_device_without_a_card_fails_and_computes_nothing(tmp_path, monkeypatch, capsys):
    f = write_file(tmp_path / "a.fa", SAMPLE1_FASTA)
    out = tmp_path / "o.tsv"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_count(*args, **kwargs):
        raise AssertionError("computed without a card")

    monkeypatch.setattr(count, "run_count", no_count)
    assert cli.main(["count", "-k", "5", "-i", str(f), "-o", str(out)]) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "no CUDA device" in err and "--device cpu" in err
    assert not out.exists()
