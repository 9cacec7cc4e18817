"""The port's count/build slice as a whole: its CLI against
orion_kmer_tpu.cli.main, byte for byte, and its DeviceCountTable against
the JAX one started from the same state."""

import gzip

import numpy as np
import pytest

from orion_kmer_tpu import codec
from orion_kmer_tpu import engine as jax_engine
from orion_kmer_tpu.cli import main as jax_main
from orion_kmer_tpu_torch import engine
from orion_kmer_tpu_torch.cli import main as port_main
from orion_kmer_tpu_torch.keys import table_from_jax

from .util import SAMPLE1_FASTA, SAMPLE2_FASTQ, TEST_INPUT1_FASTA, TEST_INPUT2_FASTQ, write_file

FIXTURES = {
    "sample1.fa": SAMPLE1_FASTA,
    "sample2.fq": SAMPLE2_FASTQ,
    "input1.fa.gz": TEST_INPUT1_FASTA,
    "input2.fq.gz": TEST_INPUT2_FASTQ,
}


def _random_fasta(seed, n_records, length):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_records):
        s = bytearray(rng.choice(list(b"ACGT"), size=length).astype(np.uint8))
        for p in rng.integers(0, length - 10, size=3):
            s[p : p + int(rng.integers(1, 8))] = b"N" * 8  # may lengthen the record
        text = s.decode()
        recs.append(f">r{i}\n" + "\n".join(text[j : j + 70] for j in range(0, len(text), 70)) + "\n")
    return "".join(recs)


def _run_both(tmp_path, argv_of):
    """Run argv_of(out_dir) through both CLIs; returns the two out dirs."""
    outs = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / name
        d.mkdir()
        assert main(argv_of(d)) == 0
        outs.append(d)
    return outs


def _content(path):
    """File bytes; decompressed for .gz, whose header stamps the time."""
    data = path.read_bytes()
    return gzip.decompress(data) if path.suffix == ".gz" else data


def _assert_dirs_equal(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert _content(a / n) == _content(b / n), n


@pytest.mark.parametrize("k", [5, 15, 21, 31, 32])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_count_cli_matches_jax(tmp_path, fixture, k):
    f = write_file(tmp_path / fixture, FIXTURES[fixture])
    a, b = _run_both(
        tmp_path,
        lambda d: ["count", "-k", k, "-i", f, "-o", d / "out.tsv", "--histogram", d / "h.txt"],
    )
    _assert_dirs_equal(a, b)


@pytest.mark.parametrize("k", [15, 21, 31, 32])
def test_count_cli_min_count_multi_file(tmp_path, k):
    text = _random_fasta(k, 3, 3000)
    f1 = write_file(tmp_path / "a.fa.gz", text)
    f2 = write_file(tmp_path / "b.fa", _random_fasta(k + 1, 2, 2000) + text)
    a, b = _run_both(
        tmp_path,
        lambda d: ["count", "-k", k, "-i", f1, f2, "-m", 2, "-o", d / "out.tsv.gz",
                   "--histogram", d / "h.txt"],
    )
    _assert_dirs_equal(a, b)
    assert _content(b / "out.tsv.gz")  # f1 repeats in f2: counts >= 2 exist


@pytest.mark.parametrize("command", ["count", "build"])
def test_checkpoint_resume_matches_jax(tmp_path, command):
    """A checkpoint that already lists the first file: both CLIs skip it
    and resume from its saved state."""
    f1 = write_file(tmp_path / "a.fa", _random_fasta(3, 2, 2000))
    f2 = write_file(tmp_path / "b.fa.gz", _random_fasta(4, 2, 2000))
    flag = "-i" if command == "count" else "-g"

    def argv(d):
        return [command, "-k", 21, flag, f1, f2, "-o", d / "out", "--checkpoint", d / "ck.npz"]

    a, b = _run_both(tmp_path, argv)  # writes the checkpoints
    for d in (a, b):
        (d / "out").unlink()
    for d, main in ((a, jax_main), (b, port_main)):
        assert main(argv(d)) == 0  # resumes: every file already done
    assert (a / "out").read_bytes() == (b / "out").read_bytes()


def test_trace_writes_a_profile(tmp_path):
    f = write_file(tmp_path / "a.fa", SAMPLE1_FASTA)
    trace = tmp_path / "trace"
    assert port_main(["--trace", trace, "count", "-k", 5, "-i", f, "-o", tmp_path / "o.tsv"]) == 0
    assert list(trace.glob("trace.*.json"))


def test_count_t40_k32_edge(tmp_path):
    f = write_file(tmp_path / "t.fa", ">t\n" + "T" * 40 + "\n")
    a, b = _run_both(tmp_path, lambda d: ["count", "-k", 32, "-i", f, "-o", d / "out.tsv"])
    _assert_dirs_equal(a, b)
    assert (b / "out.tsv").read_text() == "A" * 32 + "\t9\n"


def test_count_bad_k_error_path(tmp_path, capsys):
    f = write_file(tmp_path / "a.fa", SAMPLE1_FASTA)
    errs = []
    for main in (jax_main, port_main):
        assert main(["count", "-k", "33", "-i", str(f), "-o", str(tmp_path / "o.tsv")]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1]
    assert "Invalid K-mer size" in errs[1]


def test_unported_subcommand_exits_2(tmp_path):
    with pytest.raises(SystemExit) as e:
        port_main(["compare", "--db1", "a", "--db2", "b", "-o", str(tmp_path / "x")])
    assert e.value.code == 2


@pytest.mark.parametrize("k", [15, 21, 31])
def test_build_cli_matches_jax(tmp_path, k):
    g1 = write_file(tmp_path / "g1.fa.gz", _random_fasta(10 + k, 2, 4000))
    g2 = write_file(tmp_path / "g2.fa", TEST_INPUT1_FASTA + _random_fasta(20 + k, 1, 1500))
    a, b = _run_both(tmp_path, lambda d: ["build", "-k", k, "-g", g1, g2, "-o", d / "db.db"])
    _assert_dirs_equal(a, b)
    assert (b / "db.db").stat().st_size > 8 * 8000


@pytest.mark.parametrize("flush_windows", [8192, 1 << 16])
def test_count_deep_forest_and_spills(tmp_path, monkeypatch, flush_windows):
    """Small batches, a lowered flush bound and table bound: the forest
    deepens (for the larger flush bound), the device table spills to the
    host accumulator at least twice, and the output stays byte-exact."""
    text = _random_fasta(77, 4, 40000)
    f = write_file(tmp_path / "in.fa", text)
    a = tmp_path / "jax.tsv"
    assert jax_main(["count", "-k", 21, "-i", f, "-o", a]) == 0

    monkeypatch.setenv("ORION_KMER_BATCH", "8192")
    monkeypatch.setattr(engine.DeviceCountTable, "FLUSH_WINDOWS", flush_windows)
    monkeypatch.setattr(engine.DeviceCountTable, "DEVICE_TABLE_MAX", 8192)
    calls = {"spill": 0, "merge": 0}
    orig_spill, orig_merge = engine.DeviceCountTable._spill, engine.merge_runs

    def spill(self):
        calls["spill"] += 1
        return orig_spill(self)

    def merge_runs(x, y):
        calls["merge"] += 1
        return orig_merge(x, y)

    monkeypatch.setattr(engine.DeviceCountTable, "_spill", spill)
    monkeypatch.setattr(engine, "merge_runs", merge_runs)
    b = tmp_path / "port.tsv"
    assert port_main(["count", "-k", 21, "-i", f, "-o", b]) == 0
    assert calls["spill"] >= 2
    if flush_windows > 8192:
        assert calls["merge"] >= 7  # 8 batches per flush fold 3 levels deep
    assert a.read_bytes() == b.read_bytes()
    assert len(b.read_bytes().splitlines()) > 100000


@pytest.mark.parametrize("k", [15, 21, 31])
def test_table_seeded_from_jax_state(k):
    """Both tables start from the same JAX table state (carried across by
    keys.table_from_jax), fold the same batch, and must agree."""
    rng = np.random.default_rng(k)
    genome = rng.choice(list(b"ACGT"), size=3000).astype(np.uint8)
    first = codec.seq_to_codes(genome[:2000].tobytes())
    second = codec.seq_to_codes(genome[1000:].tobytes())

    jt = jax_engine.DeviceCountTable(k)
    jt.update(first)
    jt.flush()
    *planes, n_dev = jt._table
    keys, counts, n = table_from_jax(planes, int(n_dev), k)
    assert n == keys.shape[0] == counts.shape[0] > 0

    pt = engine.DeviceCountTable(k, "cpu")
    pt._table = (keys, counts)
    jt.update(second)
    pt.update(second)
    for g, e in zip(pt.result(), jt.result()):
        np.testing.assert_array_equal(g, e)
    # and the seeded state itself round-trips
    vals, cnts = jt.result()
    assert int(cnts.sum()) == codec.extract_kmers_np(first, k).shape[0] + codec.extract_kmers_np(second, k).shape[0]


def test_unique_from_file_matches_jax(tmp_path):
    f = write_file(tmp_path / "g.fa", _random_fasta(5, 3, 2500))
    np.testing.assert_array_equal(
        engine.unique_from_file(f, 25, "cpu"), jax_engine.unique_from_file(f, 25)
    )
