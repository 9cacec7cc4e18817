"""The port's sharded counting (parallel/mesh.py, parallel/sharded.py and
the engine's ORION_KMER_SHARDS hook) against the JAX package on its
8-device CPU mesh and against the numpy oracle.

Inputs come from numpy seeds and go through both packages; the port runs
S logical shards on the CPU.  Tolerance: none, every comparison is of
integers or bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_kmer_tpu import codec
from orion_kmer_tpu import engine as jax_engine
from orion_kmer_tpu.cli import main as jax_main
from orion_kmer_tpu.parallel import make_mesh as jax_make_mesh
from orion_kmer_tpu.parallel import sharded as jax_sharded
from orion_kmer_tpu.parallel import sharded_count as jax_sharded_count
from orion_kmer_tpu_torch import engine
from orion_kmer_tpu_torch.keys import SENTINEL_KEY, keys_from_u64, u64_from_keys
from orion_kmer_tpu_torch.parallel import ShardedCountTable, make_mesh, sharded_count
from orion_kmer_tpu_torch.ops import hash as hash_ops
from orion_kmer_tpu_torch.parallel import sharded

from .test_torch_count import port_cpu
from .test_torch_ingest import jax_native_loaded  # noqa: F401  (a fixture)

SHARDS = [1, 2, 3, 4, 8]
KS = [13, 16, 21, 31, 32]


def _codes(n=3000, seed=0, n_rate=0.02):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    codes[rng.random(n) < n_rate] = 255
    return codes


def _oracle(codes, k):
    return np.unique(codec.extract_kmers_np(codes, k), return_counts=True)


def _cpu_mesh(n_shards):
    return make_mesh(n_shards, "cpu")


# ------------------------------------------------------------------- mesh


def test_make_mesh_cpu_shards():
    assert _cpu_mesh(4) == [torch.device("cpu")] * 4
    assert make_mesh(devices=torch.device("cpu")) == [torch.device("cpu")]


def test_make_mesh_round_robin_over_devices():
    devs = [torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 2)]
    assert make_mesh(devices=devs) == devs
    assert make_mesh(5, devs) == [devs[0], devs[1], devs[2], devs[0], devs[1]]
    assert make_mesh(2, devs) == devs[:2]


def test_make_mesh_default_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


def test_make_mesh_default_is_every_visible_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_mesh() == [torch.device("cuda", i) for i in range(4)]
    assert make_mesh(6)[4:] == [torch.device("cuda", 0), torch.device("cuda", 1)]


# -------------------------------------------------------------- ownership


@pytest.mark.parametrize("n_shards", SHARDS)
def test_owner_of_matches_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    vals = np.concatenate([
        rng.integers(0, 1 << 63, 4000, dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, 4000, dtype=np.uint64),
        rng.integers(0, 1 << 20, 500, dtype=np.uint64),
        np.array([0, 1, (1 << 64) - 2, (1 << 32) - 1, 1 << 32], dtype=np.uint64),
    ])
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray(vals.astype(np.uint32))
    want = np.asarray(jax_sharded._owner_of(hi, lo, n_shards)).astype(np.int64)
    got = hash_ops.owner_of(keys_from_u64(vals), n_shards).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n_shards


@pytest.mark.parametrize("n_shards", SHARDS)
def test_route_to_owners_exact_segments(n_shards):
    """Every valid key lands in its owner's segment, in position order;
    the sentinel of an invalid window is routed nowhere."""
    rng = np.random.default_rng(10 + n_shards)
    vals = rng.integers(0, 1 << 62, 2000, dtype=np.uint64)
    keys = keys_from_u64(vals)
    invalid = torch.from_numpy(rng.random(2000) < 0.1)
    keys[invalid] = SENTINEL_KEY
    segments = sharded.route_to_owners(keys, n_shards)
    assert len(segments) == n_shards
    owner = hash_ops.owner_of(keys, n_shards)
    for d, seg in enumerate(segments):
        assert torch.equal(seg, keys[~invalid & (owner == d)])
        assert not (seg == SENTINEL_KEY).any()
    assert sum(s.shape[0] for s in segments) == int((~invalid).sum())


@pytest.mark.parametrize("k,n_shards,n", [(5, 1, 100), (21, 3, 1000), (31, 4, 4096), (32, 8, 777), (13, 8, 5)])
def test_shard_blocks_matches_jax(k, n_shards, n):
    codes = _codes(n, seed=n)
    want = jax_sharded._shard_blocks(codes, codes > 3, k, n_shards)
    got = sharded.shard_blocks(codes, codes > 3, k, n_shards)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------- sharded_count


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("k", KS)
def test_sharded_count_matches_jax_and_oracle(k, n_shards):
    codes = _codes(seed=k)
    exp_vals, exp_counts = _oracle(codes, k)
    assert exp_vals.shape[0] > 1000
    vals, counts = sharded_count(codes, codes > 3, k, _cpu_mesh(n_shards))
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)
    assert vals.dtype == np.uint64 and counts.dtype == np.int64
    jv, jc = jax_sharded_count(codes, codes > 3, k, mesh=jax_make_mesh(n_devices=n_shards))
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(counts, jc)


def test_sharded_count_shard_invariance():
    codes = _codes(5000, seed=7, n_rate=0.2)
    results = [sharded_count(codes, codes > 3, 17, _cpu_mesh(s)) for s in SHARDS]
    for vals, counts in results[1:]:
        np.testing.assert_array_equal(vals, results[0][0])
        np.testing.assert_array_equal(counts, results[0][1])


def test_sharded_count_skewed_batch_is_exact():
    """One k-mer dominates, so one owner receives nearly everything: the
    batch that forces the JAX package's capacity retry is exact in one
    pass here, and both agree."""
    k = 7
    codes = codec.seq_to_codes(b"ACGTACG" * 800)
    exp_vals, exp_counts = _oracle(codes, k)
    vals, counts = sharded_count(codes, codes > 3, k, _cpu_mesh(8))
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)
    jv, jc = jax_sharded_count(
        codes, codes > 3, k, mesh=jax_make_mesh(n_devices=8), capacity_factor=0.05
    )
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(counts, jc)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_sharded_count_t40_k32_edge(n_shards):
    """T*40 at k = 32: every window is T^32, whose u64 is the all-ones
    sentinel and whose canonical form is A^32 = 0, counted 9 times."""
    codes = codec.seq_to_codes(b"T" * 40)
    vals, counts = sharded_count(codes, codes > 3, 32, _cpu_mesh(n_shards))
    assert vals.tolist() == [0] and counts.tolist() == [9]
    table = ShardedCountTable(32, _cpu_mesh(n_shards))
    table.update(codes)
    vals, counts = table.result()
    assert vals.tolist() == [0] and counts.tolist() == [9]


def test_sharded_count_of_nothing_valid():
    codes = np.full(100, 255, np.uint8)
    vals, counts = sharded_count(codes, codes > 3, 21, _cpu_mesh(4))
    assert vals.shape == (0,) and counts.shape == (0,)


def test_assemble_sorts_the_shards_disjoint_tables():
    a = (keys_from_u64(np.array([5, 9], np.uint64)), torch.tensor([1, 2]))
    b = (keys_from_u64(np.array([1, 7, 1 << 63], np.uint64)), torch.tensor([3, 4, 5]))
    vals, counts = sharded._assemble([a, b])
    assert vals.tolist() == [1, 5, 7, 9, 1 << 63] and counts.tolist() == [3, 1, 4, 2, 5]
    assert u64_from_keys(a[0]).tolist() == [5, 9]


# ------------------------------------------------- engine hook and the CLI


def _reads_fasta(path, seed=44, n_records=30):
    """Random records with N runs; every third one appears twice, so some
    k-mers pass a min-count of 2."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGTN"), rng.integers(10, 400), p=[0.24] * 4 + [0.04]))
            for _ in range(n_records)]
    seqs += seqs[::3]
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    return path


@pytest.mark.parametrize("mode,kind,n_shards", [
    ("0", engine.DeviceCountTable, None),
    ("1", engine.DeviceCountTable, None),
    ("auto", engine.DeviceCountTable, None),
    ("junk", engine.DeviceCountTable, None),
    ("4", ShardedCountTable, 4),
    ("8", ShardedCountTable, 8),
])
def test_make_count_table_modes_on_the_cpu(monkeypatch, mode, kind, n_shards):
    monkeypatch.setenv("ORION_KMER_SHARDS", mode)
    table = engine.make_count_table(21, "cpu")
    assert type(table) is kind
    if n_shards:
        assert table.mesh == [torch.device("cpu")] * n_shards


@pytest.mark.parametrize("mode,cards,mesh", [
    ("auto", 1, None),
    ("auto", 4, None),
    ("4", 4, [0, 1, 2, 3]),
    ("0", 4, None),
    ("2", 4, [0, 1]),
    ("6", 4, [0, 1, 2, 3, 0, 1]),
    ("4", 1, [0, 0, 0, 0]),
])
def test_make_count_table_modes_on_cards(monkeypatch, mode, cards, mesh):
    """auto = the single table on the requested card, however many are
    visible; N = N logical shards round-robin over the cards.  Only the
    tables are built: nothing touches a card."""
    monkeypatch.setenv("ORION_KMER_SHARDS", mode)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    table = engine.make_count_table(31, "cuda")
    if mesh is None:
        assert type(table) is engine.DeviceCountTable and table.device == torch.device("cuda")
    else:
        assert table.mesh == [torch.device("cuda", i) for i in mesh]


@pytest.mark.usefixtures("jax_native_loaded")
@pytest.mark.parametrize("n_shards", [0, 4, 8])
def test_count_file_sharded_matches_jax_and_single(tmp_path, monkeypatch, n_shards):
    path = _reads_fasta(tmp_path / "reads.fasta")
    monkeypatch.setenv("ORION_KMER_SHARDS", "0")
    v0, c0 = engine.count_file(path, 13, "cpu")
    monkeypatch.setenv("ORION_KMER_SHARDS", str(n_shards))
    v1, c1 = engine.count_file(path, 13, "cpu")
    jv, jc = jax_engine.count_file(path, 13)
    for v, c in ((v1, c1), (jv, jc)):
        np.testing.assert_array_equal(v, v0)
        np.testing.assert_array_equal(c, c0)


def test_count_file_sharded_goes_through_the_sharded_table(tmp_path, monkeypatch):
    path = _reads_fasta(tmp_path / "reads.fasta", n_records=5)
    updates = []
    orig = ShardedCountTable.update
    monkeypatch.setattr(ShardedCountTable, "update", lambda self, codes: (updates.append(self.n_shards), orig(self, codes))[1])
    monkeypatch.setenv("ORION_KMER_SHARDS", "3")
    monkeypatch.setenv("ORION_KMER_BATCH", "4096")
    engine.count_file(path, 9, "cpu")
    assert updates and set(updates) == {3}


@pytest.mark.usefixtures("jax_native_loaded")
@pytest.mark.parametrize("k", [13, 31])
@pytest.mark.parametrize("n_shards", [0, 4, 8])
def test_count_cli_sharded_matches_jax_cli(tmp_path, monkeypatch, n_shards, k):
    """`count` (and `build`, the same pipeline) under ORION_KMER_SHARDS
    writes the JAX CLI's bytes; small batches make several updates."""
    path = _reads_fasta(tmp_path / "reads.fasta", seed=k)
    monkeypatch.setenv("ORION_KMER_SHARDS", str(n_shards))
    monkeypatch.setenv("ORION_KMER_BATCH", "4096")
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_cpu)):
        d = tmp_path / name
        d.mkdir()
        assert main(["count", "-k", str(k), "-m", "2", "--histogram", str(d / "h.txt"),
                     "-i", str(path), "-o", str(d / "o.tsv")]) == 0
        assert main(["build", "-k", str(k), "-g", str(path), "-o", str(d / "g.db")]) == 0
        outs[name] = [(d / f).read_bytes() for f in ("o.tsv", "h.txt", "g.db")]
    assert outs["jax"] == outs["port"]
    assert len(outs["port"][0]) > 0
