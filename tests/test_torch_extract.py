"""The port's extraction (ops.kmers_lanes / ops.extract, the plain path of
K1) against the JAX extractors: extract_canonical_lanes (XLA) and
extract_canonical_lanes_pallas (Pallas, interpret mode on the CPU).

Everything is integer, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_kmer_tpu import codec
from orion_kmer_tpu.engine import pack_for_transfer
from orion_kmer_tpu.ops.kmers_lanes import extract_canonical_lanes as jax_extract
from orion_kmer_tpu.ops.kmers_pallas import extract_canonical_lanes_pallas as jax_extract_pallas
from orion_kmer_tpu_torch.keys import SENTINEL_KEY, u64_from_keys
from orion_kmer_tpu_torch.ops import extract
from orion_kmer_tpu_torch.ops.kmers_lanes import extract_canonical_lanes

KS = [1, 2, 15, 16, 17, 21, 31, 32]


def _records_codes(rng, n_records=5):
    """Codes of several records joined by k-1-free separators: N runs,
    lowercase and invalid bytes inside, as the packer sees them."""
    parts = []
    for _ in range(n_records):
        seq = bytearray(rng.choice(list(b"ACGTacgt"), size=int(rng.integers(20, 900))).astype(np.uint8))
        for _ in range(3):
            p, run = int(rng.integers(0, len(seq))), int(rng.integers(1, 12))
            seq[p : p + run] = b"N" * len(seq[p : p + run])
        parts.append(codec.seq_to_codes(bytes(seq)))
        parts.append(np.full(int(rng.integers(0, 40)), codec.INVALID_CODE, np.uint8))
    return np.concatenate(parts)


def _jax_position_order(hi, lo, valid):
    """(16, W) offset-major JAX output -> position-ordered u64 + valid."""
    hi, lo, valid = (np.asarray(x).T.reshape(-1) for x in (hi, lo, valid))
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64), valid


def _port(lanes, inv, k, n):
    return extract_canonical_lanes(
        torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32)), k, n
    )


@pytest.mark.parametrize("k", KS)
def test_extract_matches_jax_xla(k):
    rng = np.random.default_rng(k)
    codes = _records_codes(rng)
    n = codes.shape[0]  # not a multiple of 16 in general
    size = -(-n // 32) * 32 + 32
    lanes, inv = pack_for_transfer(codes, size)
    jv, jvalid = _jax_position_order(*jax_extract(jnp.asarray(lanes), jnp.asarray(inv), k, n))
    keys, valid = _port(lanes, inv, k, n)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(u64_from_keys(keys)[jvalid], jv[jvalid])
    # and against the numpy oracle, in position order
    np.testing.assert_array_equal(u64_from_keys(keys)[valid.numpy()], codec.extract_kmers_np(codes, k))
    assert valid.sum() > n // 2


@pytest.mark.parametrize("k", KS)
def test_extract_matches_jax_pallas(k):
    rng = np.random.default_rng(100 + k)
    seq = rng.choice(list(b"ACGTN"), size=6000, p=[0.24] * 4 + [0.04]).astype(np.uint8)
    codes = codec.seq_to_codes(seq.tobytes())
    n = 6000 - 5
    codes = codes[:n]
    lanes, inv = pack_for_transfer(codes, 8192)
    jv, jvalid = _jax_position_order(
        *jax_extract_pallas(jnp.asarray(lanes), jnp.asarray(inv), k, n)
    )
    keys, n_valid = extract.extract_keys(
        torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32)), k, n
    )
    assert int(n_valid) == int(jvalid.sum())
    got = u64_from_keys(keys)
    np.testing.assert_array_equal(got[jvalid], jv[jvalid])
    # invalid windows hold the sentinel
    assert (keys.numpy()[~jvalid] == SENTINEL_KEY).all()


@pytest.mark.parametrize("k", [8, 32])
def test_exact_boundary_no_padding(k):
    # n_positions == 16 * W: the last windows must not read past the end
    n = 4096
    rng = np.random.default_rng(0)
    codes = codec.seq_to_codes(rng.choice(list(b"ACGT"), size=n).astype(np.uint8).tobytes())
    lanes, inv = pack_for_transfer(codes, n)
    keys, valid = _port(lanes, inv, k, n)
    np.testing.assert_array_equal(u64_from_keys(keys)[valid.numpy()], codec.extract_kmers_np(codes, k))
    jv, jvalid = _jax_position_order(*jax_extract(jnp.asarray(lanes), jnp.asarray(inv), k, n))
    np.testing.assert_array_equal(valid.numpy(), jvalid)


def test_t40_k32_is_counted_not_dropped():
    # T^32 is the u64 all-ones value before canonicalization; its
    # canonical A^32 must come out as a valid key
    codes = codec.seq_to_codes(b"T" * 40)
    lanes, inv = pack_for_transfer(codes, 64)
    keys, n_valid = extract.extract_keys(
        torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32)), 32, 40
    )
    assert int(n_valid) == 9
    assert (u64_from_keys(keys[:9]) == 0).all()


def test_extract_rejects_bad_operands():
    lanes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        extract.extract_keys(lanes, torch.zeros(2, dtype=torch.int32), 33, 64)
    with pytest.raises(ValueError):
        extract.extract_keys(lanes, torch.zeros(3, dtype=torch.int32), 5, 64)
    with pytest.raises(TypeError):
        extract.extract_keys(lanes.long(), torch.zeros(2, dtype=torch.int32), 5, 64)
