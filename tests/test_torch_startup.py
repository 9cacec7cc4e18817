"""The CLI's cold start, in fresh processes as a user runs it.

Here on the CPU (``--device cpu``): the port's host modules import no
torch, so a host stage could start before ``import torch``; every command
that reads FASTA/FASTQ writes the bytes of the ``codec.py`` oracle; errors
give the JAX CLI's one line and exit 1; without a card every subcommand
fails at the card check, before it imports any module of the port
beyond the argument parser's or reads any input.  After ``cli.main`` returns no ``okt-*`` thread is alive on
any of these paths.  Each case runs under its own time bound, so a hang
fails that case and the suite goes on."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from orion_kmer_tpu import codec
from orion_kmer_tpu.cli import main as jax_main
from orion_kmer_tpu.ops.hash import splitmix64_np

from .test_torch_ingest import jax_native_loaded  # noqa: F401  (a fixture)
from .test_torch_small_batch import K, TEXTS, kmers, oracle_db, oracle_tsv, records
from .util import write_file

ROOT = Path(__file__).resolve().parent.parent
BOUND_S = 60

# the port's CLI in this process: its exit code, the inputs it read (each
# call of the host's parse and the DB's load), the port's modules that
# cli.main imported, and the okt-* threads alive after it returned; an exception out of cli.main ends the process as it would the
# CLI (exit 1, a traceback); argv[1] is Python run first (a monkeypatch),
# or "-"
FRESH = """
import sys, threading, traceback
exec(sys.argv[1] if sys.argv[1] != "-" else "")
from orion_kmer_tpu_torch import db, host
from orion_kmer_tpu_torch.cli import main
read = []
def recorded(owner, name):
    fn = getattr(owner, name)
    def call(*a, **kw):
        read.append(name)
        return fn(*a, **kw)
    setattr(owner, name, call)
recorded(host, "native_chunks")
recorded(host, "stream_file_batches")
recorded(db.KmerDb, "load")
before = {m for m in sys.modules if m.startswith("orion_kmer_tpu_torch")}
try:
    rc = main(sys.argv[2:])
except Exception:
    traceback.print_exc()
    rc = 1
print(repr(sorted(set(read))))
print(repr(sorted(m for m in sys.modules if m.startswith("orion_kmer_tpu_torch") and m not in before)))
print(repr(sorted(t.name for t in threading.enumerate() if t.name.startswith("okt-"))))
sys.exit(rc)
"""


def fresh(argv, patch="-", device=("--device", "cpu")):
    """(exit code, inputs read, the port's modules cli.main imported,
    okt-* threads left, stderr) of the port's CLI in a fresh process."""
    proc = subprocess.run([sys.executable, "-c", FRESH, patch, *device, *map(str, argv)], cwd=ROOT,
                          capture_output=True, text=True, timeout=BOUND_S)
    lines = proc.stdout.splitlines()
    assert len(lines) >= 3, proc.stderr
    return proc.returncode, eval(lines[-3]), eval(lines[-2]), eval(lines[-1]), proc.stderr


@pytest.fixture
def files(tmp_path):
    return {name: write_file(tmp_path / name, text) for name, text in TEXTS.items()}


def test_the_host_modules_import_no_torch():
    code = ("import sys\nimport orion_kmer_tpu_torch.cli, orion_kmer_tpu_torch.host, orion_kmer_tpu_torch.db, "
            "orion_kmer_tpu_torch.ingest\nprint('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=BOUND_S)
    assert proc.stdout == "False\n", proc.stderr


def counts_with_histogram(names):
    v, c = np.unique(np.concatenate([kmers(n) for n in names]), return_counts=True)
    keep = c >= 2
    tsv = b"".join(codec.u64_to_seq(int(x), K) + b"\t%d\n" % n for x, n in zip(v[keep].tolist(), c[keep].tolist()))
    m, f = np.unique(c, return_counts=True)
    return tsv, b"".join(b"%d\t%d\n" % (a, b) for a, b in zip(m.tolist(), f.tolist()))


@pytest.mark.parametrize("case", ["count", "count resumed", "build", "sketch", "query", "classify"])
def test_a_fresh_cli_writes_the_oracles_bytes(tmp_path, files, case):
    out = tmp_path / "out"
    if case == "count":
        argv = ["count", "-k", K, "-m", 2, "--histogram", out.with_suffix(".hist"), "-i", files["m.fq"],
                files["a.fa"], "-o", out]
    elif case == "count resumed":
        ck = tmp_path / "ck.npz"
        rc, _, _, left, err = fresh(["count", "-k", K, "-i", files["a.fa"], "-o", out, "--checkpoint", ck])
        assert (rc, left) == (0, []), err
        argv = ["count", "-k", K, "-i", files["a.fa"], files["m.fq"], "-o", out, "--checkpoint", ck]
    elif case == "build":
        argv = ["build", "-k", K, "-g", files["a.fa"], files["m.fq"], "-o", out]
    elif case == "sketch":
        argv = ["sketch", "-k", K, "--scaled", 1, "-i", files["m.fq"], files["a.fa"], "-o", out]
    else:
        db = tmp_path / "g.db"
        db.write_bytes(oracle_db(["a.fa", "r.fa"] if case == "classify" else ["a.fa"]))
        if case == "query":
            argv = ["query", "-d", db, "-r", files["m.fq"], "-c", 1, "-o", out]
        else:
            argv = ["classify", "-i", files["m.fq"], "-d", db, "--min-kmer-frequency", 1, "-o", out]
    rc, _, _, left, err = fresh(argv)
    assert (rc, left) == (0, []), err
    data = out.read_bytes()
    if case == "count":
        assert (data, out.with_suffix(".hist").read_bytes()) == counts_with_histogram(["m.fq", "a.fa"])
    elif case == "count resumed":
        assert data == oracle_tsv(np.concatenate([kmers("a.fa"), kmers("m.fq")]))
    elif case == "build":
        assert data == oracle_db(["a.fa", "m.fq"])
    elif case == "sketch":
        for sk, name in zip(json.loads(data)["sketches"], ("m.fq", "a.fa")):
            h, n = np.unique(splitmix64_np(kmers(name)), return_counts=True)  # scaled 1 keeps every hash
            assert ([int(x) for x in sk["hashes"]], sk["abundances"]) == (h.tolist(), n.tolist())
    elif case == "query":
        vals = np.unique(kmers("a.fa"))
        assert data == b"".join(
            r.id + b"\n" for r in records("m.fq")
            if len(r.seq) >= K
            and np.isin(codec.extract_kmers_np(codec.seq_to_codes(r.seq, normalize=False), K), vals).sum() >= 1
        )
    else:
        doc = json.loads(data)
        inputs = np.unique(kmers("m.fq"))
        assert doc["total_unique_kmers_in_input"] == inputs.shape[0]
        for r in doc["databases_analyzed"][0]["references"]:
            hits = np.isin(inputs, np.unique(kmers(r["reference_name"]))).sum()
            assert r["input_kmers_hitting_reference"] == int(hits)


@pytest.mark.usefixtures("jax_native_loaded")
@pytest.mark.parametrize("case", ["missing input", "malformed FASTQ", "k = 33", "missing DB"])
def test_an_error_gives_the_jax_clis_line(tmp_path, capsys, case):
    bad = write_file(tmp_path / "bad.fq", "@r1\nACGTACGTAC\n+\nIIIIIIIIII\n@r2\nACGTACGT\nIIIIIIII\n")
    out = tmp_path / "out"
    argv = {
        "missing input": ["count", "-k", K, "-i", tmp_path / "none.fa", "-o", out],
        "malformed FASTQ": ["count", "-k", K, "-i", bad, "-o", out],
        "k = 33": ["count", "-k", 33, "-i", bad, "-o", out],
        "missing DB": ["query", "-d", tmp_path / "none.db", "-r", bad, "-o", out],
    }[case]
    assert jax_main([str(a) for a in argv]) == 1
    want = capsys.readouterr().err
    assert want.count("\n") == 1 and want.startswith("[ERROR orion_kmer_tpu] Error: ")
    rc, _, _, left, err = fresh(argv)
    assert (rc, left, err) == (1, [], want)
    assert not out.exists()


@pytest.mark.parametrize("command", ["count", "build", "compare", "query", "classify", "sketch", "sketch-compare",
                                     "profile", "serve"])
def test_without_a_card_a_subcommand_fails_before_it_reads_anything(tmp_path, files, command):
    db = tmp_path / "g.db"
    db.write_bytes(oracle_db(["a.fa"]))
    sig = tmp_path / "s.sig"
    sig.write_text(json.dumps({"format": "orion-kmer-tpu-sketch", "version": 1, "k": K, "scaled": 1, "num": 0,
                               "sketches": []}))
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps([{"sample": "S", "files": [str(files["m.fq"])]}]))
    out = tmp_path / "out"
    argv = {
        "count": ["count", "-k", K, "-i", files["m.fq"], "-o", out],
        "build": ["build", "-k", K, "-g", files["a.fa"], "-o", out],
        "compare": ["compare", "--db1", db, "--db2", db, "-o", out],
        "query": ["query", "-d", db, "-r", files["m.fq"], "-o", out],
        "classify": ["classify", "-i", files["m.fq"], "-d", db, "-o", out],
        "sketch": ["sketch", "-k", K, "-i", files["m.fq"], "-o", out],
        "sketch-compare": ["sketch-compare", "-s", sig, "-o", out],
        "profile": ["profile", "-k", K, "--manifest", manifest, "-o", out],
        "serve": ["serve", "--socket", tmp_path / "s.sock"],
    }[command]
    rc, read, imported, left, err = fresh(argv, patch="import torch\ntorch.cuda.is_available = lambda: False",
                                          device=())
    # the argument parser's own: cohort adds its subcommands' parsers
    parser = ["orion_kmer_tpu_torch.commands", "orion_kmer_tpu_torch.commands.cohort"]
    assert (rc, read, imported, left) == (1, [], parser, [])
    assert err.count("\n") == 1 and "no CUDA device" in err and "--device cpu" in err
    assert not out.exists() and not (tmp_path / "s.sock").exists()
