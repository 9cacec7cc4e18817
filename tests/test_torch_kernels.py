"""The port's kernel wrappers: dispatch (plain version on the CPU, kernel
or an error elsewhere, never a quiet fallback), and -- on a card -- each
CUDA kernel against its plain version at edge shapes.

This file imports no jax, so the card tests run on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from orion_kmer_tpu import codec
from orion_kmer_tpu_torch import _kernels
from orion_kmer_tpu_torch.host import pack_for_transfer
from orion_kmer_tpu_torch.ops import compact, extract, merge


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
        extract.extract_keys(
            torch.empty(8, dtype=torch.int32, device=device),
            torch.empty(4, dtype=torch.int32, device=device),
            5,
            64,
        )


def _wire(rng, n, size):
    seq = rng.choice(list(b"ACGTN"), size=n, p=[0.24] * 4 + [0.04]).astype(np.uint8)
    lanes, inv = pack_for_transfer(codec.seq_to_codes(seq.tobytes()), size)
    return torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,size", [(5000, 8192), (4096, 4096), ((1 << 20) - 37, 1 << 20)])
def test_extract_kernel_matches_plain(cuda, n, size):
    rng = np.random.default_rng(n)
    lanes, inv = _wire(rng, n, size)
    for k in (1, 2, 15, 16, 17, 21, 31, 32):
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
