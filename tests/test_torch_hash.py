"""The port's 64-bit hashes (ops/hash.py) against the JAX package's limb
versions and the numpy oracles, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from orion_kmer_tpu.ops import hash as jax_hash
from orion_kmer_tpu_torch.keys import keys_from_u64, u64_from_keys
from orion_kmer_tpu_torch.ops import hash as port_hash

EDGES = np.array([0, 1, 2, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], dtype=np.uint64)


def _values(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, 1 << 64, size=20000, dtype=np.uint64), EDGES])


def _planes(vals):
    return jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)), jnp.asarray(vals.astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splitmix64_matches_jax_and_oracle(seed):
    vals = _values(seed)
    got = u64_from_keys(port_hash.splitmix64(keys_from_u64(vals)))
    hi, lo = jax_hash.splitmix64_pair(*_planes(vals))
    jax_vals = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    np.testing.assert_array_equal(got, jax_vals)
    np.testing.assert_array_equal(got, jax_hash.splitmix64_np(vals))
    np.testing.assert_array_equal(port_hash.splitmix64_np(vals), jax_hash.splitmix64_np(vals))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_matches_jax_and_oracle(seed):
    vals = _values(seed)
    got = port_hash.mix32(keys_from_u64(vals)).numpy()
    assert got.min() >= 0 and got.max() < 1 << 32
    np.testing.assert_array_equal(got, np.asarray(jax_hash.mix32_pair(*_planes(vals))).astype(np.int64))
    np.testing.assert_array_equal(got, jax_hash.mix32_np(vals).astype(np.int64))
    np.testing.assert_array_equal(port_hash.mix32_np(vals), jax_hash.mix32_np(vals))


def test_flipped_hash_order_is_u64_order():
    """Sorting the flipped int64 hashes sorts the u64 hashes."""
    vals = _values(3)
    h = port_hash.splitmix64(keys_from_u64(vals))
    np.testing.assert_array_equal(u64_from_keys(h.sort().values), np.sort(jax_hash.splitmix64_np(vals)))
