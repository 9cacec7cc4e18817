"""The port's cross-process sharded count (parallel/distributed.py) over
gloo on the CPU: the environment contract, the backend choice, one process
group of one rank in this process, and two real processes.

Tolerance: none, every comparison is of integers.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from orion_kmer_tpu import codec
from orion_kmer_tpu_torch.parallel import distributed


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_group():
    """A gloo group of one rank in this process, always torn down."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_two_process_distributed_sharded_count(tmp_path):
    """Two processes join one gloo group through ORION_KMER_COORDINATOR /
    _NUM_PROCESSES / _PROCESS_ID; each checks the count against the oracle
    and both agree."""
    res = distributed.run_two_process_smoke(tmp_path, timeout=180.0, device="cpu")
    assert res["processes"] == 2 and res["unique"] > 0
    st = res["a2a_stats"]
    assert st["backend"] == "gloo" and st["n_shards"] == 2 and st["positions"] == 4096
    assert 0 < st["ici_bytes_per_position"] < st["a2a_bytes_per_position"] <= 8


def test_smoke_reaps_its_workers_on_failure(tmp_path, monkeypatch):
    """A worker that fails makes the smoke raise with its stderr; none is
    left running."""
    monkeypatch.setattr(distributed, "_SMOKE_WORKER", "import sys\nsys.exit('worker broke')\n")
    with pytest.raises(RuntimeError, match="worker broke"):
        distributed.run_two_process_smoke(tmp_path, timeout=60.0, device="cpu")


def test_smoke_times_out_and_kills(tmp_path, monkeypatch):
    monkeypatch.setattr(distributed, "_SMOKE_WORKER", "import time\ntime.sleep(600)\n")
    with pytest.raises(RuntimeError, match="timed out"):
        distributed.run_two_process_smoke(tmp_path, timeout=2.0, device="cpu")


def test_not_configured_means_no_group(monkeypatch):
    for name in ("ORION_KMER_COORDINATOR", "ORION_KMER_NUM_PROCESSES", "ORION_KMER_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("ORION_KMER_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("ORION_KMER_NUM_PROCESSES", "1")
    assert distributed.maybe_initialize_distributed("cpu") is False  # one process: nothing to join
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,cards,world,backend", [
    ("cpu", 0, 2, "gloo"),
    ("cpu", 4, 2, "gloo"),
    ("cuda", 1, 2, "gloo"),  # two ranks would share the card
    ("cuda", 2, 2, "nccl"),
    ("cuda", 4, 2, "nccl"),
    ("cuda", 4, 8, "gloo"),
])
def test_backend_choice(monkeypatch, device, cards, world, backend):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.choose_backend(device, world) == backend


def test_rank_device(monkeypatch, one_rank_group):
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.rank_device("cuda:3") == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.rank_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.rank_device("cuda") == torch.device("cuda", 0)


@pytest.mark.parametrize("k", [9, 21, 32])
def test_one_rank_group_matches_oracle(one_rank_group, k):
    """The whole exchange (counts, split sizes, ragged gather) with one
    rank: every key's owner is this process."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    codes[rng.random(3000) < 0.02] = 255
    codes[:40] = 3
    stats = {}
    vals, counts = distributed.multihost_sharded_count(codes, codes > 3, k, "cpu", stats=stats)
    exp_vals, exp_counts = np.unique(codec.extract_kmers_np(codes, k), return_counts=True)
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)
    assert stats["n_shards"] == 1 and stats["ici_bytes_per_position"] == 0.0
    assert stats["a2a_bytes_per_position"] == round(8 * int(exp_counts.sum()) / 3000, 3)
    assert distributed.maybe_initialize_distributed("cpu") is False  # a group of one


@pytest.mark.parametrize("shards,per_rank", [(2, [2, 2]), ((2, 1), [2, 1])])
def test_two_processes_of_several_shards(tmp_path, shards, per_rank):
    """Two ranks of several CPU shards each (2 + 2, as the JAX package's
    smoke makes 2 processes x 2 devices, and an uneven 2 + 1): every count
    of the worker (k = 9, 21, 32 and the T*40 edge) equals the oracle on
    both ranks, over S = the sum of the ranks' shards."""
    res = distributed.run_two_process_smoke(tmp_path, timeout=180.0, device="cpu", shards=shards)
    assert res["shards"] == per_rank
    assert res["devices"] == [["cpu"] * n for n in per_rank]
    assert [c["count"] for c in res["counts"]] == ["k=9", "k=21", "k=32", "T*40, k=32"]
    for c in res["counts"]:
        st = c["stats"]
        assert st["n_shards"] == sum(per_rank) and st["n_processes"] == 2 and st["backend"] == "gloo"
    assert res["counts"][-1]["unique"] == 1  # T^32 and A^32 are one canonical k-mer
    st = res["a2a_stats"]
    assert 0 < st["ici_bytes_per_position"] < st["a2a_bytes_per_position"] <= 8


@pytest.mark.parametrize("ranks,cards,expected", [
    (1, 1, [[0]]),
    (2, 1, [[0], [0]]),
    (4, 1, [[0], [0], [0], [0]]),
    (1, 4, [[0, 1, 2, 3]]),
    (2, 4, [[0, 2], [1, 3]]),
    (4, 4, [[0], [1], [2], [3]]),
])
def test_local_devices(ranks, cards, expected):
    """A lone rank takes every card, two ranks on four cards take two
    each, one rank per card takes its own, and ranks share a lone card."""
    hosts = ["node-a"] * ranks
    assert [distributed.local_devices(hosts, r, cards) for r in range(ranks)] == expected


def test_local_devices_per_host_and_without_a_card():
    """Local ranks count per host name; no card raises."""
    hosts = ["node-a", "node-b", "node-a", "node-b"]
    assert [distributed.local_devices(hosts, r, 4) for r in range(4)] == [[0, 2], [0, 2], [1, 3], [1, 3]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_devices(hosts, 0, 0)


@pytest.mark.parametrize("ranks_per_host,cards,backend", [(2, 4, "nccl"), (4, 4, "nccl"), (2, 1, "gloo"), (8, 4, "gloo")])
def test_backend_choice_by_ranks_per_host(ranks_per_host, cards, backend):
    assert distributed.choose_backend("cuda", ranks_per_host, cards) == backend


@pytest.mark.parametrize("k", [9, 21, 32])
def test_one_rank_of_two_shards_matches_oracle(one_rank_group, k):
    """One rank with two CPU shards: the exchange is all peer copies."""
    rng = np.random.default_rng(100 + k)
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    codes[rng.random(3000) < 0.02] = 255
    codes[-40:] = 3
    stats = {}
    vals, counts = distributed.multihost_sharded_count(codes, codes > 3, k, "cpu", stats=stats, devices=["cpu", "cpu"])
    exp_vals, exp_counts = np.unique(codec.extract_kmers_np(codes, k), return_counts=True)
    np.testing.assert_array_equal(vals, exp_vals)
    np.testing.assert_array_equal(counts, exp_counts)
    assert stats["n_shards"] == 2 and stats["n_processes"] == 1 and stats["ici_bytes_per_position"] == 0.0
