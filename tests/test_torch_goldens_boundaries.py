"""The reference's size-boundary CLI suite (tests/test_boundaries.py) run
against the port's CLI on the CPU.

The autouse fixture points ``tests.util.cli_main`` at the port's
``cli.main`` with ``--device cpu`` in front.

Re-exported unchanged: ``test_query_db_and_reads_cross_bucket_boundary``
(a DB and a read set past 4,096 entries).

Twinned, on the port's own objects (the reference cases lower bounds of
the JAX engine, which the port does not read):
  * ``test_count_cli_spill_past_device_table_max[15, 21, 31]``: the port's
    ``DeviceCountTable.FLUSH_WINDOWS`` and ``DEVICE_TABLE_MAX`` at 8,192,
    ``ORION_KMER_BATCH=8192``, spills counted on its ``_spill``;
  * ``test_count_cli_spill_sharded``: the same through the port's
    ``ShardedCountTable`` bounds (``FLUSH_WINDOWS`` 8,192,
    ``DEVICE_TABLE_MAX`` 4,096 a shard) with ``ORION_KMER_SHARDS=4``
    (four CPU shards); a shard is a ``DeviceCountTable``, so the spills
    are counted there, and each shard spills once more at ``result()``;
  * ``test_classify_chunk_seam_and_bucket_boundary``: the port's
    ``ClassifyJoiner.MAX_JOIN`` at 3,400.

Tolerance: none, every comparison is of bytes or integers.
"""

import json

import numpy as np
import pytest

from orion_kmer_tpu import codec
from orion_kmer_tpu_torch.engine import ClassifyJoiner
from orion_kmer_tpu_torch.parallel.streaming import ShardedCountTable
from orion_kmer_tpu_torch.table import DeviceCountTable

from . import util
from .test_boundaries import (  # noqa: F401  (a re-exported case, then helpers)
    _assert_text_equal,
    _count_spills,
    _oracle_count_tsv,
    _random_seq,
    test_query_db_and_reads_cross_bucket_boundary,
)
from .test_torch_count import port_cpu
from .util import run_cli, write_file


@pytest.fixture(autouse=True)
def port_cli(monkeypatch):
    """Every ``run_cli`` of these cases runs the port's CLI on the CPU."""
    monkeypatch.setattr(util, "cli_main", port_cpu)


def _count_fasta(tmp_path, seqs, k):
    f = write_file(tmp_path / "in.fa", "".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    out = tmp_path / "out.tsv"
    assert run_cli("count", "-k", k, "-i", f, "-o", out) == 0
    return out.read_text()


@pytest.mark.parametrize("k", [15, 21, 31])
def test_count_cli_spill_past_device_table_max(tmp_path, monkeypatch, k):
    """Twin: with 8,192-position batches, flushes and table bound, the
    device table spills to the host tier mid-run and the TSV stays
    byte-exact."""
    monkeypatch.setenv("ORION_KMER_BATCH", "8192")
    monkeypatch.setattr(DeviceCountTable, "FLUSH_WINDOWS", 8192)
    monkeypatch.setattr(DeviceCountTable, "DEVICE_TABLE_MAX", 8192)
    spills = _count_spills(monkeypatch, DeviceCountTable)
    rng = np.random.default_rng(100 + k)
    seqs = [_random_seq(rng, 12000) for _ in range(4)]  # ~48k uniques >> 8192
    got = _count_fasta(tmp_path, seqs, k)
    assert spills["n"] >= 2  # host tier crossed mid-run, not just at result()
    _assert_text_equal(got, _oracle_count_tsv(seqs, k))


def test_count_cli_spill_sharded(tmp_path, monkeypatch):
    """Twin: the same bound crossing through four CPU shards."""
    monkeypatch.setenv("ORION_KMER_SHARDS", "4")
    monkeypatch.setenv("ORION_KMER_BATCH", "8192")
    monkeypatch.setattr(ShardedCountTable, "FLUSH_WINDOWS", 8192)
    # the bound holds each shard's table at its exact length (the JAX
    # package's holds twice a padded capacity): a shard owns ~7,500 of
    # the ~30,000 uniques, so 4,096 is crossed mid-run
    monkeypatch.setattr(ShardedCountTable, "DEVICE_TABLE_MAX", 4096)
    spills = _count_spills(monkeypatch, DeviceCountTable)
    rng = np.random.default_rng(7)
    seqs = [_random_seq(rng, 10000) for _ in range(3)]
    got = _count_fasta(tmp_path, seqs, 21)
    assert spills["n"] > 4  # one per shard at result(), and at least one mid-run
    _assert_text_equal(got, _oracle_count_tsv(seqs, 21))


def test_classify_chunk_seam_and_bucket_boundary(tmp_path, monkeypatch):
    """Twin: several references per MAX_JOIN chunk and several chunks per
    database, with the input table and the references past 4,096 k-mers:
    the same bytes as one join, and the oracle's per-reference stats."""
    k = 13
    rng = np.random.default_rng(23)
    genomes = {f"ref{i}.fa": _random_seq(rng, 1600) for i in range(6)}
    gpaths = [write_file(tmp_path / nm, f">{nm}\n{s}\n") for nm, s in genomes.items()]
    db = tmp_path / "refs.db"
    assert run_cli("build", "-k", k, "-g", *gpaths, "-o", db) == 0
    parts = [genomes[f"ref{i}.fa"][:800] for i in range(3)]
    parts.append(_random_seq(rng, 4000))
    inp = write_file(tmp_path / "in.fa", "".join(f">s{i}\n{p}\n" for i, p in enumerate(parts)))
    input_kmers = {}
    for p in parts:
        for v in codec.extract_kmers_np(codec.seq_to_codes(p.encode()), k).tolist():
            input_kmers[v] = input_kmers.get(v, 0) + 1
    assert len(input_kmers) > 4096

    outs = {}
    for name, max_join in (("single", ClassifyJoiner.MAX_JOIN), ("chunked", 3400)):
        # ~1588 uniques a reference: 3400 packs 2 references a chunk, 3 chunks
        monkeypatch.setattr(ClassifyJoiner, "MAX_JOIN", max_join)
        o, t = tmp_path / f"{name}.json", tmp_path / f"{name}.tsv"
        assert run_cli("classify", "-i", inp, "-d", db, "-o", o, "--output-tsv", t) == 0
        outs[name] = (o.read_text(), t.read_text())
    assert outs["single"] == outs["chunked"]

    refs = {r["reference_name"]: r for r in json.loads(outs["chunked"][0])["databases_analyzed"][0]["references"]}
    assert set(refs) == set(genomes)  # default --min-coverage 0.0 keeps all
    for nm, seq in genomes.items():
        ref_set = set(codec.extract_kmers_np(codec.seq_to_codes(seq.encode()), k).tolist())
        matched = {v for v in input_kmers if v in ref_set}
        r = refs[nm]
        assert r["input_kmers_hitting_reference"] == len(matched)
        assert r["total_kmers_in_reference"] == len(ref_set)
        assert r["sum_depth_of_matched_kmers_in_input"] == sum(input_kmers[v] for v in matched)
