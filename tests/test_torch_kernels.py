"""The port's kernel wrappers: dispatch (plain version on the CPU, kernel
or an error elsewhere, never a quiet fallback), and -- on a card -- each
CUDA kernel against its plain version at edge shapes.

This file imports no jax, so the card tests run on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from orion_kmer_tpu_torch import _kernels, codec
from orion_kmer_tpu_torch.host import pack_for_transfer
from orion_kmer_tpu_torch.keys import SENTINEL_KEY, keys_from_u64
from orion_kmer_tpu_torch.ops import compact, extract, merge, setops, sort


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cpu_path_never_loads_the_kernels(monkeypatch):
    def no_kernels():
        raise AssertionError("the CPU path asked for the CUDA kernels")

    monkeypatch.setattr(_kernels, "lib", no_kernels)
    x = torch.arange(10, dtype=torch.int64)
    merge.merge(x, x)
    compact.compact([x], x > 3)
    sort.sort_pairs(x)
    lanes, inv = _wire(np.random.default_rng(0), 100, 128)
    extract.extract_keys(lanes, inv, 5, 100)


def test_non_cpu_non_cuda_tensors_raise():
    device = "meta"
    x = torch.empty(8, dtype=torch.int64, device=device)
    with pytest.raises(ValueError):
        merge.merge(x, x)
    with pytest.raises(ValueError):
        compact.compact([x], torch.empty(8, dtype=torch.bool, device=device))
    with pytest.raises(ValueError):
        sort.sort_pairs(x)
    with pytest.raises(ValueError):
        extract.extract_keys(
            torch.empty(8, dtype=torch.int32, device=device),
            torch.empty(4, dtype=torch.int32, device=device),
            5,
            64,
        )


def test_cpu_path_of_every_k3_mode_never_loads_the_kernels(monkeypatch):
    def no_kernels():
        raise AssertionError("the CPU path asked for the CUDA kernels")

    monkeypatch.setattr(_kernels, "lib", no_kernels)
    x = torch.arange(10, dtype=torch.int64)
    compact.compact([x, x], x > 3)
    compact.compact_positions(x, x > 3, torch.tensor(7))
    compact.partition(x, 3)


def test_every_k3_mode_raises_on_non_cpu_non_cuda_tensors():
    x = torch.empty(8, dtype=torch.int64, device="meta")
    keep = torch.empty(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        compact.compact_positions(x, keep)
    with pytest.raises(ValueError):
        compact.partition(x, 4)


def _wire(rng, n, size):
    seq = rng.choice(list(b"ACGTN"), size=n, p=[0.24] * 4 + [0.04]).astype(np.uint8)
    lanes, inv = pack_for_transfer(codec.seq_to_codes(seq.tobytes()), size)
    return torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,size",
    # K1 walks 4224-position tiles: one partial tile, exact tiles, a ragged last tile
    [(1, 32), (5000, 8192), (4096, 4096), (8448, 8448), (12700, 12704), ((1 << 20) - 37, 1 << 20)],
)
def test_extract_kernel_matches_plain(cuda, n, size):
    rng = np.random.default_rng(n)
    lanes, inv = _wire(rng, n, size)
    for k in range(1, 33):
        pk, pn = extract.extract_keys_plain(lanes, inv, k, n)
        gk, gn = extract.extract_keys(lanes.to(cuda), inv.to(cuda), k, n)
        assert torch.equal(pk, gk.cpu()) and int(pn) == int(gn), k


@pytest.mark.cuda
@pytest.mark.parametrize(
    "na,nb", [(0, 5), (5, 0), (1, 1), (3000, 17), (2048, 2048), (100000, 333333)]
)
def test_merge_kernel_matches_plain(cuda, na, nb):
    rng = np.random.default_rng(na + nb)
    a = torch.sort(torch.from_numpy(rng.integers(-50, 50, na))).values
    b = torch.sort(torch.from_numpy(rng.integers(-50, 50, nb))).values
    pa, pb = torch.arange(na), torch.arange(nb) + na
    ek, ep = merge.merge_plain(a, b, pa, pb)
    gk, gp = merge.merge(a.to(cuda), b.to(cuda), pa.to(cuda), pb.to(cuda))
    assert torch.equal(ek, gk.cpu()) and torch.equal(ep, gp.cpu())
    gk2, none = merge.merge(a.to(cuda), b.to(cuda))
    assert none is None and torch.equal(ek, gk2.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 100, 2048, 2049, (1 << 20) + 5])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 0.97, 1.0])
def test_compact_kernel_matches_plain(cuda, n, density):
    rng = np.random.default_rng(n)
    keep = torch.from_numpy(rng.random(n) < density)
    x0 = torch.from_numpy(rng.integers(-(2**62), 2**62, n))
    x1 = torch.arange(n)
    (e0, e1), en = compact.compact_plain([x0, x1], keep)
    (g0, g1), gn = compact.compact([x0.to(cuda), x1.to(cuda)], keep.to(cuda))
    m = int(gn)
    assert m == int(en)
    assert torch.equal(e0, g0[:m].cpu()) and torch.equal(e1, g1[:m].cpu())


# K3 ranks 2048-element tiles: empty, one element, a tile less and more one,
# several tiles with a ragged end
K3_SIZES = [0, 1, 2047, 2049, (1 << 20) + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("n", K3_SIZES)
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("offset", [0, 1])  # 1: a view that is not 16-byte aligned
def test_compact_one_plane_kernel_matches_plain(cuda, n, density, offset):
    rng = np.random.default_rng(n + offset)
    x = torch.from_numpy(rng.integers(-(2**62), 2**62, n + offset)).to(cuda)[offset:]
    keep = torch.from_numpy(rng.random(n + offset) < density).to(cuda)[offset:]
    (e,), en = compact.compact_plain([x], keep)
    (g,), gn = compact.compact([x], keep)
    m = int(gn)
    assert m == int(en) and torch.equal(e, g[:m])


@pytest.mark.cuda
@pytest.mark.parametrize("n", K3_SIZES)
@pytest.mark.parametrize("density", [0.0, 0.03, 0.97, 1.0])
@pytest.mark.parametrize("limit", [None, 0, 1000, 1 << 30])
def test_compact_positions_kernel_matches_plain(cuda, n, density, limit):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-(2**62), 2**62, n)).to(cuda)
    keep = torch.from_numpy(rng.random(n) < density).to(cuda)
    lim = None if limit is None else torch.tensor(limit, device=cuda)
    (ek, ei), en = compact.compact_positions_plain(keys, keep, lim)
    before = compact.launches
    (gk, gi), gn = compact.compact_positions(keys, keep, lim)
    assert compact.launches == before + (n > 0)
    m = int(gn)
    assert m == int(en) and torch.equal(ek, gk[:m]) and torch.equal(ei, gi[:m])


@pytest.mark.cuda
@pytest.mark.parametrize("n", K3_SIZES)
@pytest.mark.parametrize("n_dest", [1, 2, 3, 4, 5, 8, 13])
def test_partition_kernel_matches_plain(cuda, n, n_dest):
    rng = np.random.default_rng(n * 31 + n_dest)
    keys = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n + 1, dtype=np.int64)).to(cuda)
    keys[torch.from_numpy(rng.random(n + 1) < 0.1).to(cuda)] = SENTINEL_KEY
    keys = keys[1:]  # a view that is not 16-byte aligned
    ebufs, ecounts = compact.partition_plain(keys, n_dest)
    before = compact.launches
    gbufs, gcounts = compact.partition(keys, n_dest)
    assert compact.launches == before + (n > 0)
    assert torch.equal(ecounts, gcounts)
    for e, g, m in zip(ebufs, gbufs, gcounts.tolist()):
        assert torch.equal(e, g[:m])
    again = compact.partition(keys, n_dest)[0]
    assert all(torch.equal(a[:m], g[:m]) for a, g, m in zip(again, gbufs, gcounts.tolist()))


@pytest.mark.cuda
# K4 runs clusters of 1 (n <= 2048), 2, 4 and 8 CTAs
@pytest.mark.parametrize("n", [1, 2, 3, 1000, 2047, 2048, 2049, 4097, 8193, 12289, 1 << 14])
def test_sort_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64))
    keys[: n // 4] = keys[n // 4 : 2 * (n // 4)]  # duplicates
    keys[0] = 2**63 - 1  # ties with the kernel's padding
    before = sort.launches
    got = sort.sort_pairs(keys.to(cuda))
    assert sort.launches == before + 1
    assert torch.equal(got.cpu(), sort.sort_pairs_plain(keys))


@pytest.mark.cuda
def test_joins_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(9)
    d = keys_from_u64(np.unique(rng.integers(0, 1 << 16, 5000, dtype=np.uint64)))
    q = keys_from_u64(rng.integers(0, 1 << 16, 7000, dtype=np.uint64))
    valid = torch.from_numpy(rng.random(7000) < 0.9)
    assert torch.equal(setops.membership(q, valid, d), setops.membership(q.to(cuda), valid.to(cuda), d.to(cuda)).cpu())
    for a, b in zip(setops.classify_join(q, d), setops.classify_join(q.to(cuda), d.to(cuda))):
        assert torch.equal(a, b.cpu())
    assert int(setops.intersection_size(d, d[::2].contiguous())) == int(
        setops.intersection_size(d.to(cuda), d[::2].contiguous().to(cuda))
    )
    e = d[:0]
    for q_, d_ in ((q, e), (e, d), (e, e)):
        got = setops.classify_join(q_.to(cuda), d_.to(cuda))
        assert not got[0].any() and not got[1].any()
        assert got[0].shape == q_.shape and got[1].shape == d_.shape
    for a_, b_ in ((d, e), (e, d), (e, e)):  # sorted unique sides only
        assert int(setops.intersection_size(a_.to(cuda), b_.to(cuda))) == 0
