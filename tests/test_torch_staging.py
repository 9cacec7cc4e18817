"""The host <-> device link (``staging.py``) on the CPU: ``PinnedRing``
packs each batch into new tensors, equal to ``pack_for_transfer``'s
output, which later batches leave intact; ``to_host`` gives a CPU
tensor's own memory."""

import numpy as np
import pytest
import torch

from orion_kmer_tpu_torch import host, staging

CPU = torch.device("cpu")


def _codes(rng, n):
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.random(n) < 0.05] = 255
    return codes


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize(
    "n,size,n_starts",
    [
        (1 << 14, host._bucket(1 << 14), None),  # a full count batch
        (4097, host._bucket(4097), None),  # a count's tail batch, padded to its bucket
        (1000, host.wire_size(1000), 7),  # a query batch and its record starts
        (0, host._bucket(0), None),  # no positions
    ],
)
def test_the_cpu_stager_returns_fresh_tensors_equal_to_the_pack(n, size, n_starts, parts):
    rng = np.random.default_rng(n)
    batches = [_codes(rng, n) for _ in range(staging.PinnedRing.SLOTS + 1)]
    starts = None if n_starts is None else np.sort(rng.integers(0, n, n_starts))
    ring = staging.PinnedRing(CPU, parts)
    try:
        staged = [ring.stage(codes, size, starts) for codes in batches]
    finally:
        ring.close()
    for codes, got in zip(batches, staged):
        lanes, inv = host.pack_for_transfer(codes, size)
        assert len(got) == (2 if starts is None else 3)
        assert all(t.device == CPU for t in got)
        assert torch.equal(got[0], torch.from_numpy(lanes.view(np.int32)))
        assert torch.equal(got[1], torch.from_numpy(inv.view(np.int32)))
        if starts is not None:
            assert got[2].dtype == torch.int64 and got[2].tolist() == starts.tolist()
    ptrs = [t.data_ptr() for got in staged for t in got if t.numel()]
    assert len(set(ptrs)) == len(ptrs)  # no buffer is packed twice


def test_to_host_on_the_cpu_is_the_tensors_own_memory():
    a = torch.arange(10, dtype=torch.int64)
    b = torch.arange(5, dtype=torch.int32) * 3
    got = staging.to_host(a, b)
    for t, g in zip((a, b), got):
        assert np.array_equal(g, t.numpy()) and g.dtype == t.numpy().dtype
        assert g.ctypes.data == t.data_ptr()
