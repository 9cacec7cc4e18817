"""The port's run merge (ops.merge, the plain path of K2 here) against the
JAX merges: merge_sorted_streams (raw forest runs) and
merge_sorted_planes (counted tables, as combine_sorted_unique uses it),
both through the Pallas bitonic merge in interpret mode at power-of-two
totals, and against numpy at lengths that are not powers of two.

Keys must agree exactly.  The bitonic merge leaves payload order within
equal keys unspecified, so payloads are compared as per-key sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_kmer_tpu.ops import sort_pallas as sp
from orion_kmer_tpu_torch.keys import keys_from_u64, u64_from_keys
from orion_kmer_tpu_torch.ops import merge


def _sorted_u64(rng, n, dup_range=None):
    if dup_range:  # many duplicates, as in raw forest runs
        v = rng.integers(0, dup_range, size=n, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    else:
        v = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    return np.sort(v)


def _planes(v):
    return (v >> np.uint64(32)).astype(np.uint32), v.astype(np.uint32)


def _per_key_sums(keys, payload):
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(uniq.shape[0], np.int64)
    np.add.at(sums, inv, payload)
    return uniq, sums


@pytest.mark.parametrize("log_total", [14, 15, 16, 17])
def test_merge_matches_jax_streams(log_total):
    rng = np.random.default_rng(log_total)
    half = 1 << (log_total - 1)
    a, b = _sorted_u64(rng, half, dup_range=half), _sorted_u64(rng, half, dup_range=half)
    jhi, jlo = sp.merge_sorted_streams(*map(jnp.asarray, (*_planes(a), *_planes(b))))
    jv = (np.asarray(jhi).astype(np.uint64) << np.uint64(32)) | np.asarray(jlo)
    keys, payload = merge.merge(keys_from_u64(a), keys_from_u64(b))
    assert payload is None
    np.testing.assert_array_equal(u64_from_keys(keys), jv)


@pytest.mark.parametrize("split", [(1 << 13, 1 << 13), (3 << 13, 1 << 13)])
def test_merge_with_payload_matches_jax_planes(split):
    na, nb = split
    rng = np.random.default_rng(na)
    a, b = np.unique(_sorted_u64(rng, na)), np.unique(_sorted_u64(rng, nb))
    b[: nb // 4] = a[: nb // 4]  # shared keys, as when a table meets a flush
    b = np.sort(b)
    a, b = a[: na], b[: nb]
    ca = rng.integers(1, 1 << 40, size=a.shape[0]).astype(np.int64)
    cb = rng.integers(1, 1 << 40, size=b.shape[0]).astype(np.int64)

    def cplanes(c):
        return (c & 0xFFFFFFFF).astype(np.uint32), (c >> 32).astype(np.uint32)

    out = sp.merge_sorted_planes(
        [jnp.asarray(p) for p in (*_planes(a), *cplanes(ca))],
        [jnp.asarray(p) for p in (*_planes(b), *cplanes(cb))],
    )
    jv = (np.asarray(out[0]).astype(np.uint64) << np.uint64(32)) | np.asarray(out[1])
    jc = (np.asarray(out[3]).astype(np.int64) << 32) | np.asarray(out[2]).astype(np.int64)
    keys, payload = merge.merge(
        keys_from_u64(a), keys_from_u64(b), torch.from_numpy(ca), torch.from_numpy(cb)
    )
    got_v = u64_from_keys(keys)
    np.testing.assert_array_equal(got_v, jv)
    gk, gs = _per_key_sums(got_v, payload.numpy())
    ek, es = _per_key_sums(jv, jc)
    np.testing.assert_array_equal(gk, ek)
    np.testing.assert_array_equal(gs, es)


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 7), (9, 0), (1, 1), (1000, 3), (2047, 2049), (5000, 12345)])
def test_merge_matches_numpy_any_lengths(na, nb):
    rng = np.random.default_rng(na * 7 + nb)
    a = _sorted_u64(rng, na, dup_range=max(na // 3, 2))
    b = _sorted_u64(rng, nb, dup_range=max(nb // 3, 2))
    pa = np.arange(na, dtype=np.int64)
    pb = np.arange(nb, dtype=np.int64) + na
    keys, payload = merge.merge(
        keys_from_u64(a), keys_from_u64(b), torch.from_numpy(pa), torch.from_numpy(pb)
    )
    cat = np.concatenate([a, b])
    order = np.argsort(cat, kind="stable")
    np.testing.assert_array_equal(u64_from_keys(keys), cat[order])
    # stable, a first on ties: the payload is exactly the stable order
    np.testing.assert_array_equal(payload.numpy(), np.concatenate([pa, pb])[order])


def test_merge_rejects_bad_operands():
    a = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        merge.merge(a, a, a, None)
    with pytest.raises(TypeError):
        merge.merge(a.int(), a)
    with pytest.raises(ValueError):
        merge.merge(a, a, a[:2], a)
