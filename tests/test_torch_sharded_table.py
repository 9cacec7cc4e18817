"""The port's streaming sharded count table (parallel/streaming.py)
against the JAX package's on its 8-device CPU mesh and against the numpy
oracle, on S logical CPU shards.

Tolerance: none, every comparison is of integers or bytes.
"""

import io
import threading

import numpy as np
import pytest
import torch

from orion_kmer_tpu import codec
from orion_kmer_tpu.engine import pack_for_transfer as jax_pack_for_transfer
from orion_kmer_tpu.parallel import make_mesh as jax_make_mesh
from orion_kmer_tpu.parallel.streaming import ShardedCountTable as JaxShardedCountTable
from orion_kmer_tpu.parallel.streaming import _pack_blocks as jax_pack_blocks
from orion_kmer_tpu_torch import engine, server as srv
from orion_kmer_tpu_torch.ingest import native as port_native
from orion_kmer_tpu_torch.keys import table_from_jax
from orion_kmer_tpu_torch.parallel import ShardedCountTable, make_mesh, sharded
from orion_kmer_tpu_torch.version import __version__

SHARDS = [1, 2, 3, 4, 8]
KS = [13, 16, 21, 31, 32]


def _codes(n, rng, n_rate=0.02):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    codes[rng.random(n) < n_rate] = 255
    return codes


def _oracle(batches, k):
    """Counts of batches fed one after another: no window spans two."""
    sep = np.full(k - 1, 255, np.uint8)
    joined = np.concatenate([x for b in batches for x in (b, sep)])
    return np.unique(codec.extract_kmers_np(joined, k), return_counts=True)


def _table(k, n_shards):
    return ShardedCountTable(k, make_mesh(n_shards, "cpu"))


def _assert_result(table, batches, k):
    vals, counts = table.result()
    exp_vals, exp_counts = _oracle(batches, k)
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)
    assert vals.dtype == np.uint64 and counts.dtype == np.int64
    return vals, counts


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("k", KS)
def test_table_matches_jax_and_oracle(k, n_shards):
    """Three batches with a flush after the first, through both tables."""
    rng = np.random.default_rng(100 * k + n_shards)
    batches = [_codes(2000, rng) for _ in range(3)]  # one size: the JAX table compiles per shape
    batches[1][300:700] = 0  # a poly-A stretch: one k-mer many times
    port, ref = _table(k, n_shards), JaxShardedCountTable(k, mesh=jax_make_mesh(n_devices=n_shards))
    for i, b in enumerate(batches):
        port.update(b)
        ref.update(b)
        if i == 0:
            port.flush()
            ref.flush()
    vals, counts = _assert_result(port, batches, k)
    jv, jc = ref.result()
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(counts, jc)


@pytest.mark.parametrize("k", [13, 21, 31])
def test_every_shard_holds_what_the_jax_shard_holds(k):
    """Same owner formula, so after a flush shard s of the port holds the
    keys and counts of row s of the JAX table."""
    rng = np.random.default_rng(k)
    codes = _codes(4000, rng)
    port, ref = _table(k, 4), JaxShardedCountTable(k, mesh=jax_make_mesh(n_devices=4))
    for t in (port, ref):
        t.update(codes)
        t.flush()
    *planes, n = (np.asarray(p) for p in ref._table)
    for s, shard in enumerate(port._shards):
        keys, counts, m = table_from_jax([p[s] for p in planes], int(n[s]), k)
        assert m > 0
        assert torch.equal(shard._table[0], keys) and torch.equal(shard._table[1], counts)


def test_shard_count_invariance():
    rng = np.random.default_rng(32)
    codes = _codes(6000, rng, n_rate=0.05)
    results = []
    for n_shards in SHARDS:
        t = _table(11, n_shards)
        t.update(codes)
        results.append(t.result())
    for vals, counts in results[1:]:
        np.testing.assert_array_equal(vals, results[0][0])
        np.testing.assert_array_equal(counts, results[0][1])


def test_matches_the_single_device_table():
    rng = np.random.default_rng(5)
    batches = [_codes(3000, rng) for _ in range(3)]
    single, sharded = engine.DeviceCountTable(21, "cpu"), _table(21, 3)
    for b in batches:
        single.update(b)
        sharded.update(b)
    v0, c0 = single.result()
    v1, c1 = sharded.result()
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(c0, c1)


def test_skewed_batch_is_exact():
    """Every window of the poly-A stretch has one owner; the JAX table
    needs its capacity retry for it, the exact-length exchange does not."""
    k = 9
    codes = np.zeros(4000, dtype=np.uint8)
    codes[3000:] = np.random.default_rng(3).integers(0, 4, 1000)
    t = _table(k, 4)
    t.update(codes)
    assert t.stats["route_retries"] == 0 and t.stats["route_dispatches"] == 1
    vals, counts = _assert_result(t, [codes], k)
    ref = JaxShardedCountTable(k, mesh=jax_make_mesh(n_devices=4), capacity_factor=0.05)
    ref.update(codes)
    assert ref.stats["route_retries"] > 0
    jv, jc = ref.result()
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(counts, jc)


def test_explicit_invalid_mask():
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 3000, dtype=np.uint8)
    invalid = rng.random(3000) < 0.03
    t = _table(15, 4)
    t.update(codes, invalid)
    _assert_result(t, [np.where(invalid, 255, codes).astype(np.uint8)], 15)


def test_empty_batch_and_empty_table():
    t = _table(21, 4)
    t.update(np.empty(0, np.uint8))
    assert t.stats["updates"] == 0
    vals, counts = t.result()
    assert vals.shape == (0,) and counts.shape == (0,)


def test_auto_flush(monkeypatch):
    monkeypatch.setattr(ShardedCountTable, "FLUSH_WINDOWS", 5000)
    rng = np.random.default_rng(9)
    k = 11
    t = _table(k, 4)
    batches = [rng.integers(0, 4, size=4000, dtype=np.uint8) for _ in range(4)]
    for b in batches:
        t.update(b)
    assert t._windows_since_flush < 5000  # a flush happened
    assert t.stats["flush_dispatches"] > 0
    assert all(not shard._runs for shard in t._shards)
    _assert_result(t, batches, k)


@pytest.mark.parametrize("k", [11, 21])
def test_device_resident_table_and_forced_spill(k):
    """Flushes fold into the shards' device tables; the host tier sees
    nothing until a spill, and results stay exact across one."""
    rng = np.random.default_rng(21)
    t = _table(k, 4)
    batches = []
    for _ in range(6):
        batches.append(rng.integers(0, 4, size=4000, dtype=np.uint8))
        t.update(batches[-1])
        t.flush()
        assert all(shard._acc._total == 0 for shard in t._shards)
        assert all(shard._table is not None for shard in t._shards)
    for shard in t._shards:
        shard._spill()
    assert all(shard._acc._total > 0 for shard in t._shards)
    batches.append(rng.integers(0, 4, size=4000, dtype=np.uint8))
    t.update(batches[-1])
    _assert_result(t, batches, k)
    assert t.stats["spills"] == 8  # the forced one and the final one, per shard


def test_spill_at_capacity_bound(monkeypatch):
    """DEVICE_TABLE_MAX is per shard and read from the sharded class."""
    monkeypatch.setattr(ShardedCountTable, "DEVICE_TABLE_MAX", 2048)
    rng = np.random.default_rng(23)
    k = 15
    t = _table(k, 4)
    assert all(shard.DEVICE_TABLE_MAX == 2048 for shard in t._shards)
    batches = []
    for _ in range(4):
        batches.append(rng.integers(0, 4, size=6000, dtype=np.uint8))
        t.update(batches[-1])
        t.flush()
    assert sum(shard._acc._total for shard in t._shards) > 0  # the bound forced spills
    assert t.stats["spills"] > 0
    _assert_result(t, batches, k)


def test_t16_edge_k16():
    """T^16 windows at k = 16 (canonical A^16 = 0) through two batches."""
    rng = np.random.default_rng(61)
    codes = _codes(6000, rng, n_rate=0.01)
    codes[:40] = 3
    for n_shards in (2, 4):
        t = _table(16, n_shards)
        t.update(codes[:2500])
        t.update(codes[2500:])
        vals, _ = _assert_result(t, [codes[:2500], codes[2500:]], 16)
        assert vals[0] == 0


def test_forest_levels_follow_the_batch_bucket():
    """Equal batches share one level in every shard, so two of them merge
    once per shard, whatever each shard received."""
    rng = np.random.default_rng(4)
    t = _table(21, 4)
    t.update(_codes(5000, rng))
    assert all(list(shard._runs) == [8192] for shard in t._shards)
    t.update(_codes(5000, rng))
    assert all(list(shard._runs) == [16384] for shard in t._shards)
    assert t.stats["merge_dispatches"] == 4
    t.update(_codes(100, rng))
    assert all(sorted(shard._runs) == [4096, 16384] for shard in t._shards)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_stats_identities(n_shards):
    k = 21
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=4096, dtype=np.uint8)
    t = _table(k, n_shards)
    t.update(codes)
    t.update(codes)
    _assert_result(t, [codes, codes], k)
    rep = t.stats_report()
    windows = 2 * (4096 - k + 1)  # every window valid, each routed once
    assert rep["positions"] == 8192 and rep["updates"] == 2
    assert rep["route_dispatches"] == 2 and rep["route_retries"] == 0
    assert rep["a2a_bytes_sent"] == 8 * windows
    assert rep["recv_sort_elements"] == windows
    assert rep["a2a_bytes_ici"] == 0  # the CPU shards share one device
    assert rep["merge_dispatches"] == n_shards and rep["merge_bytes"] == 8 * windows
    assert rep["flush_dispatches"] == n_shards and rep["rle_elements"] == windows
    assert rep["fold_dispatches"] == n_shards
    assert rep["spills"] == n_shards
    assert rep["host_link_bytes"] == 16 * rep["fold_elements"]
    assert rep["n_shards"] == n_shards and rep["k"] == k and rep["route"] == "int64"
    assert rep["devices"] == ["cpu"] * n_shards
    assert rep["a2a_bytes_per_position"] == round(8 * windows / 8192, 3)
    assert rep["ici_bytes_per_position"] == 0.0


def test_bytes_that_change_device_are_counted(monkeypatch):
    """With shards on different devices, a2a_bytes_ici is 8 bytes for
    every key whose owner sits elsewhere.  The devices are faked: the
    copy is replaced, the arithmetic is the table's."""
    from orion_kmer_tpu_torch.parallel import sharded

    mesh = [torch.device("cuda", 0), torch.device("cuda", 1)]
    bufs = [[torch.arange(5), torch.arange(7)], [torch.arange(3), torch.arange(2)]]
    table = np.array([[4, 6], [3, 1]])
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **kw: self)
    received, moved = sharded.exchange(bufs, table, mesh)
    assert moved == 8 * (6 + 3)
    assert [r.tolist() for r in received] == [[0, 1, 2, 3, 0, 1, 2], [0, 1, 2, 3, 4, 5, 0]]


def test_warm_is_stateless_and_results_stay_exact():
    rng = np.random.default_rng(34)
    k = 17
    t = _table(k, 4)
    t.warm()
    assert all(not s._runs and s._table is None and s._acc._total == 0 for s in t._shards)
    assert t.stats["positions"] == 0 and t.stats["updates"] == 0
    codes = _codes(2048, rng)
    t.update(codes)
    _assert_result(t, [codes], k)


def test_warm_takes_each_distinct_device_once(monkeypatch):
    """Six shards on two devices warm a scratch table of two shards."""
    meshes = []
    orig_init = ShardedCountTable.__init__

    def init(self, k, mesh=None):
        meshes.append(list(mesh))
        orig_init(self, k, [torch.device("cpu")] * len(mesh))

    monkeypatch.setattr(ShardedCountTable, "__init__", init)
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    t = ShardedCountTable(21, make_mesh(6, devs))
    t.mesh = meshes[0]
    t.warm()
    assert meshes[1] == devs


@pytest.mark.parametrize("native_on", [True, False])
def test_pack_blocks_matches_jax_and_row_packing(monkeypatch, native_on):
    if not native_on:
        monkeypatch.setenv("ORION_KMER_NATIVE", "0")
        monkeypatch.setattr(port_native, "_lib", None)
        monkeypatch.setattr(port_native, "_lib_failed", False)
    assert port_native.available() == native_on
    rng = np.random.default_rng(8)
    S, stride = 4, 100
    block = -(-stride // 32) * 32
    codes = rng.integers(0, 6, size=(S, stride)).astype(np.uint8)
    invalid = rng.random((S, stride)) < 0.2
    lanes, inv_words = sharded._pack_blocks(codes, invalid, block)
    jl, ji = jax_pack_blocks(codes, invalid, block)
    np.testing.assert_array_equal(lanes, jl)
    np.testing.assert_array_equal(inv_words, ji)
    for s in range(S):
        row = np.where(invalid[s], 255, codes[s]).astype(np.uint8)
        el, ei = jax_pack_for_transfer(row, block)
        np.testing.assert_array_equal(lanes[s], el)
        np.testing.assert_array_equal(inv_words[s], ei)


def test_serve_warm_k_with_shards(tmp_path, monkeypatch):
    """`serve --warm-k` under ORION_KMER_SHARDS=2 warms the sharded table,
    once per k, before the socket is bound (the device is claimed to be
    CUDA and handed CPU shards: there is no card here)."""
    sock = tmp_path / "warm.sock"
    warmed = []
    orig_warm = ShardedCountTable.warm

    def warm(self):
        assert not sock.exists()
        warmed.append((self.k, self.n_shards))
        self.mesh = [torch.device("cpu")] * self.n_shards
        orig_warm(self)

    monkeypatch.setenv("ORION_KMER_SHARDS", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(ShardedCountTable, "warm", warm)
    ready = threading.Event()
    t = threading.Thread(target=srv.serve, args=(sock,), daemon=True,
                         kwargs={"device": "cuda", "warm_ks": (5, 21), "on_ready": ready.set})
    t.start()
    assert ready.wait(60), "server did not come up"
    assert warmed == [(5, 2), (21, 2)]
    out = io.StringIO()
    assert srv.forward(sock, ["--version"], stdout=out, stderr=io.StringIO()) == 0
    assert __version__ in out.getvalue()
    srv.forward(sock, ["shutdown"], stdout=io.StringIO(), stderr=io.StringIO())
    t.join(30)
    assert not t.is_alive()
