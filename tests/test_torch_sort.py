"""The port's sort_pairs (K4's entry) against the JAX sort_pairs, exactly.

At n = 2^14 the JAX entry runs its Pallas bitonic network (interpret mode
on the CPU); at other sizes it runs lax.sort, as the port's entry hands
sizes above 2^14 to torch.sort."""

import numpy as np
import pytest

import jax.numpy as jnp
from orion_kmer_tpu.ops import sort_pallas
from orion_kmer_tpu_torch.keys import keys_from_planes, u64_from_keys
from orion_kmer_tpu_torch.ops import sort


def _pairs(rng, n):
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    # duplicates and both extremes, as tests/test_sort_pallas.py injects
    hi[: n // 8] = hi[n // 8 : 2 * (n // 8)]
    lo[: n // 16] = lo[n // 16 : 2 * (n // 16)]
    hi[0] = lo[0] = 0
    hi[1] = lo[1] = 0xFFFFFFFF
    return hi, lo


@pytest.mark.parametrize("n", [1 << 14, 1000, 1 << 15])
def test_sort_pairs_matches_jax(n):
    hi, lo = _pairs(np.random.default_rng(n), n)
    shi, slo = sort_pallas.sort_pairs(jnp.asarray(hi), jnp.asarray(lo))
    expected = (np.asarray(shi).astype(np.uint64) << np.uint64(32)) | np.asarray(slo)
    got = u64_from_keys(sort.sort_pairs(keys_from_planes(hi, lo)))
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("n", [0, 1, 2, 12289])
def test_sort_pairs_small_and_ragged_sizes(n):
    hi, lo = _pairs(np.random.default_rng(n), max(n, 2))
    keys = keys_from_planes(hi[:n], lo[:n])
    got = u64_from_keys(sort.sort_pairs(keys))
    np.testing.assert_array_equal(got, np.sort(u64_from_keys(keys)))
