"""The port's stable compaction (ops.compact, the plain paths of K3 here)
against sort_pallas.compact_left_pallas (Pallas, interpret mode) and
ops.count._compact_left, at 2^17 with densities 0.03, 0.5 and 0.97 as in
test_sort_pallas.py, and on ragged lengths; the positions mode against
_compact_left given an explicit position plane; and the route mode
(partition) against the JAX package's parallel/sharded.py::_owner_of."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_kmer_tpu.ops import sort_pallas as sp
from orion_kmer_tpu.ops.count import _compact_left
from orion_kmer_tpu.parallel import sharded as jax_sharded
from orion_kmer_tpu_torch.keys import SENTINEL_KEY, keys_from_planes, keys_from_u64, u64_from_keys
from orion_kmer_tpu_torch.ops import compact


@pytest.mark.parametrize("density", [0.03, 0.5, 0.97])
def test_compact_matches_jax(density):
    rng = np.random.default_rng(int(density * 100))
    n = 1 << 17
    hi, lo, cnt = (
        rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32) for _ in range(3)
    )
    keep = rng.random(n) < density
    planes = [jnp.asarray(p) for p in (hi, lo, cnt)]
    ref = _compact_left(planes, jnp.asarray(keep))
    pal = sp.compact_left_pallas(planes, jnp.asarray(keep))
    (keys, counts), n_kept = compact.compact(
        [keys_from_planes(hi, lo), torch.from_numpy(cnt.astype(np.int64))],
        torch.from_numpy(keep),
    )
    m = int(n_kept)
    assert m == int(keep.sum())
    for jax_out in (ref, pal):
        jhi, jlo, jcnt = (np.asarray(p)[:m] for p in jax_out)
        jv = (jhi.astype(np.uint64) << np.uint64(32)) | jlo.astype(np.uint64)
        np.testing.assert_array_equal(u64_from_keys(keys[:m]), jv)
        np.testing.assert_array_equal(counts[:m].numpy(), jcnt.astype(np.int64))


@pytest.mark.parametrize("n", [0, 1, 2047, 2049, 10001])
def test_compact_single_plane_ragged(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=n))
    keep = torch.from_numpy(rng.random(n) < 0.4)
    (out,), n_kept = compact.compact([x], keep)
    m = int(n_kept)
    np.testing.assert_array_equal(out[:m].numpy(), x.numpy()[keep.numpy()])


def test_compact_rejects_bad_operands():
    x = torch.zeros(8, dtype=torch.int64)
    keep = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        compact.compact([x], keep.long())
    with pytest.raises(ValueError):
        compact.compact([x, x, x], keep)
    with pytest.raises(TypeError):
        compact.compact([x[:4]], keep)


@pytest.mark.parametrize("n,density", [(1 << 15, 0.03), (1 << 15, 0.5), (1 << 15, 0.97), (2049, 0.5), (1, 1.0), (0, 0.5)])
def test_compact_positions_matches_jax(n, density):
    """Keys and their indices, as _compact_left moves (hi, lo, position)
    planes; the positions come from the kernel, not from a plane."""
    rng = np.random.default_rng(n + int(density * 100))
    hi, lo = (rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    keep = rng.random(n) < density
    pos = np.arange(n, dtype=np.uint32)
    jhi, jlo, jpos = (np.asarray(p) for p in _compact_left([jnp.asarray(p) for p in (hi, lo, pos)], jnp.asarray(keep)))
    (keys, idx), n_kept = compact.compact_positions(keys_from_planes(hi, lo), torch.from_numpy(keep))
    m = int(n_kept)
    assert m == int(keep.sum()) == keys.shape[0] == idx.shape[0]
    jv = (jhi[:m].astype(np.uint64) << np.uint64(32)) | jlo[:m].astype(np.uint64)
    np.testing.assert_array_equal(u64_from_keys(keys), jv)
    np.testing.assert_array_equal(idx.numpy(), jpos[:m].astype(np.int64))


@pytest.mark.parametrize("limit", [0, 1, 700, 2048, 5000])
def test_compact_positions_limit(limit):
    """A limit drops every index at or past it, as keep & (arange < limit)."""
    rng = np.random.default_rng(limit)
    n = 2048
    keys = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=n))
    keep = torch.from_numpy(rng.random(n) < 0.3)
    (k, i), n_kept = compact.compact_positions(keys, keep, torch.tensor(limit))
    want = np.flatnonzero(keep.numpy() & (np.arange(n) < limit))
    assert int(n_kept) == want.shape[0]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(k.numpy(), keys.numpy()[want])


def test_compact_positions_rejects_bad_operands():
    x = torch.zeros(8, dtype=torch.int64)
    keep = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        compact.compact_positions(x, keep.long())
    with pytest.raises(TypeError):
        compact.compact_positions(x, keep, torch.tensor([3]))
    with pytest.raises(TypeError):
        compact.compact_positions(x, keep, torch.tensor(3, dtype=torch.int32))


@pytest.mark.parametrize("n_dest", [1, 2, 3, 4, 8, 13])
@pytest.mark.parametrize("n", [0, 1, 2047, 5003])
def test_partition_matches_jax_owner(n_dest, n):
    """Each destination holds exactly the keys that the JAX package's
    _owner_of gives it, in position order; the sentinel goes nowhere,
    and the counts add up to the valid keys."""
    rng = np.random.default_rng(100 * n_dest + n)
    vals = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, size=n, dtype=np.uint64)
    sentinel = rng.random(n) < 0.1
    vals[sentinel] = np.uint64((1 << 64) - 1)
    keys = keys_from_u64(vals)
    assert bool((keys[torch.from_numpy(sentinel)] == SENTINEL_KEY).all())
    owner = np.asarray(jax_sharded._owner_of(
        jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)), jnp.asarray(vals.astype(np.uint32)), n_dest))
    bufs, counts = compact.partition(keys, n_dest)
    assert len(bufs) == n_dest and counts.shape == (n_dest,) and counts.dtype == torch.int64
    for d in range(n_dest):
        want = np.flatnonzero(~sentinel & (owner == d))
        assert int(counts[d]) == want.shape[0]
        np.testing.assert_array_equal(u64_from_keys(bufs[d][: int(counts[d])]), vals[want])
    assert int(counts.sum()) == int((~sentinel).sum())


def test_partition_rejects_bad_operands():
    with pytest.raises(TypeError):
        compact.partition(torch.zeros(8, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        compact.partition(torch.zeros(8, dtype=torch.int64), 0)
