"""The port's set joins (orion_kmer_tpu_torch.ops.setops) against the JAX
ones (orion_kmer_tpu.ops.setops), exactly: the same inputs, made with
numpy from a seed, through both.  The JAX joins take (hi, lo, valid)
planes padded to their buckets; the port takes int64 keys, the DB side as
exactly its valid keys."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from orion_kmer_tpu import codec
from orion_kmer_tpu.ops import setops as jax_setops
from orion_kmer_tpu.ops.kmers import split_u64
from orion_kmer_tpu_torch.keys import keys_from_u64
from orion_kmer_tpu_torch.ops import setops

FF = np.uint64(0xFFFFFFFFFFFFFFFF)


def _planes(vals):
    hi, lo = split_u64(np.asarray(vals, dtype=np.uint64))
    return jnp.asarray(hi), jnp.asarray(lo)


def _jax(fn, q, qv, d, dv):
    return fn(*_planes(q), jnp.asarray(qv), *_planes(d), jnp.asarray(dv))


def _bits(packed, n):
    return np.unpackbits(np.asarray(packed).view(np.uint8), bitorder="little")[:n].astype(bool)


def _sets(seed, nq, nd, span):
    """Queries in any order (half drawn from the DB), a sorted unique DB
    padded to nd with invalid slots, and random query validity."""
    rng = np.random.default_rng(seed)
    d = np.unique(rng.integers(0, span, size=nd, dtype=np.uint64))
    q = rng.integers(0, span, size=nq, dtype=np.uint64)
    if d.shape[0]:
        q[: nq // 2] = rng.choice(d, size=nq // 2)
    rng.shuffle(q)
    qv = rng.random(nq) < 0.9
    dv = np.arange(nd) < d.shape[0]
    d = np.pad(d, (0, nd - d.shape[0]))
    return q, qv, d, dv


CASES = {
    "random": lambda: _sets(1, 3000, 4096, 1 << 20),
    "wide": lambda: _sets(2, 2048, 2048, 1 << 63),
    "one_db_key": lambda: (
        np.array([5, 7, 5, 0], np.uint64), np.ones(4, bool), np.array([5, 0], np.uint64), np.array([True, False])
    ),
    "empty_db": lambda: (np.arange(64, dtype=np.uint64), np.ones(64, bool), np.zeros(32, np.uint64), np.zeros(32, bool)),
    "empty_queries": lambda: (np.zeros(32, np.uint64), np.zeros(32, bool), np.arange(64, dtype=np.uint64), np.ones(64, bool)),
    # an invalid window and a real T^32 window against a genuine T^32 DB
    # entry (tests/test_ops.py:194, :336)
    "t32": lambda: (np.array([FF, FF, 2], np.uint64), np.array([False, True, True]), np.array([1, FF], np.uint64), np.ones(2, bool)),
    # T^16 encodes to 0xFFFFFFFF, the u32 sentinel of the JAX k <= 16 path
    # (tests/test_ops.py:412): a plain key here, which must match
    "t16": lambda: (
        np.array([0xFFFFFFFF, 0, 0xFFFFFFFF], np.uint64), np.ones(3, bool),
        np.array([0, 0xFFFFFFFF], np.uint64), np.ones(2, bool),
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_membership_matches_jax(case):
    q, qv, d, dv = CASES[case]()
    expected = np.asarray(_jax(jax_setops.membership, q, qv, d, dv))
    got = setops.membership(keys_from_u64(q), torch.from_numpy(qv), keys_from_u64(d[dv]))
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("case", sorted(CASES))
def test_classify_join_matches_jax(case):
    q, qv, d, dv = CASES[case]()
    nq, nd = -(-q.shape[0] // 32) * 32, -(-d.shape[0] // 32) * 32  # JAX needs multiples of 32
    qp, qvp = np.pad(q, (0, nq - q.shape[0])), np.pad(qv, (0, nq - q.shape[0]))
    dp, dvp = np.pad(d, (0, nd - d.shape[0])), np.pad(dv, (0, nd - d.shape[0]))
    bits_q, bits_db = _jax(jax_setops.classify_join, qp, qvp, dp, dvp)
    exp_q, exp_db = _bits(bits_q, q.shape[0]), _bits(bits_db, d.shape[0])
    assert not exp_q[~qv].any() and not exp_db[~dv].any()
    got_q, got_db = setops.classify_join(keys_from_u64(q[qv]), keys_from_u64(d[dv]))
    np.testing.assert_array_equal(got_q.numpy(), exp_q[qv])
    np.testing.assert_array_equal(got_db.numpy(), exp_db[dv])


@pytest.mark.parametrize("seed,nq,valid", [(3, 3000, 2500), (4, 64, 0), (5, 4096, 4096), (6, 1, 1)])
def test_membership_sorted_matches_jax(seed, nq, valid):
    """Sorted unique queries over a valid prefix (tests/test_ops.py:208)."""
    rng = np.random.default_rng(seed)
    qs = np.unique(rng.integers(0, 1 << 14, size=nq, dtype=np.uint64))[:valid]
    q = np.pad(qs, (0, nq - qs.shape[0]))
    qv = np.arange(nq) < qs.shape[0]
    d = np.unique(rng.integers(0, 1 << 14, size=4096, dtype=np.uint64))
    dv = np.ones(d.shape[0], bool)
    expected = np.asarray(_jax(jax_setops.membership_sorted, q, qv, d, dv))
    got = setops.membership_sorted(keys_from_u64(q), torch.from_numpy(qv), keys_from_u64(d))
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(got.numpy()[: qs.shape[0]], np.isin(qs, d))


@pytest.mark.parametrize(
    "na,nb,span", [(3000, 5000, 1 << 14), (2048, 2048, 1 << 63), (0, 100, 1 << 10), (100, 0, 1 << 10), (1, 1, 4)]
)
def test_intersection_size_matches_jax(na, nb, span):
    rng = np.random.default_rng(na + nb)
    a = np.unique(rng.integers(0, span, size=na, dtype=np.uint64))
    b = np.unique(rng.integers(0, span, size=nb, dtype=np.uint64))
    size = max(16, 1 << max(a.shape[0], b.shape[0], 1).bit_length())
    pa, pb = np.pad(a, (0, size - a.shape[0])), np.pad(b, (0, size - b.shape[0]))
    va, vb = np.arange(size) < a.shape[0], np.arange(size) < b.shape[0]
    expected = int(jax_setops.intersection_size(*_planes(pa), jnp.asarray(va), *_planes(pb), jnp.asarray(vb)))
    assert int(setops.intersection_size(keys_from_u64(a), keys_from_u64(b))) == expected
    assert expected == np.intersect1d(a, b).shape[0]


@pytest.mark.parametrize("k", [16, 32])
def test_query_windows_against_t_runs(k):
    """K1's windows of a read with T runs (T^16 at k = 16, T^32 at k = 32,
    both canonical A^k) and an N, through member_positions: the invalid
    windows, which hold the sentinel, never match even a DB that holds
    the all-ones key."""
    from orion_kmer_tpu_torch.host import pack_for_transfer
    from orion_kmer_tpu_torch.ops.extract import extract_keys

    seq = b"T" * (k + 4) + b"N" + b"ACGT" * 10
    codes = codec.seq_to_codes(seq, normalize=False)
    size = -(-codes.shape[0] // 32) * 32
    lanes, inv = pack_for_transfer(codes, size)
    keys, n_valid = extract_keys(torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32)), k, codes.shape[0])
    skeys, order = torch.sort(keys)
    m = int(n_valid)
    db = np.unique(np.concatenate([codec.extract_kmers_np(codes[: k + 4], k), [FF]]))
    member = setops.member_positions(keys_from_u64(db), skeys[:m], order[:m], size).numpy()
    assert member[:5].all() and not member[5:].any()
