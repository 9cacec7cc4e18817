"""The port's stable compaction (ops.compact, the plain path of K3 here)
against sort_pallas.compact_left_pallas (Pallas, interpret mode) and
ops.count._compact_left, at 2^17 with densities 0.03, 0.5 and 0.97 as in
test_sort_pallas.py, and on ragged lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_kmer_tpu.ops import sort_pallas as sp
from orion_kmer_tpu.ops.count import _compact_left
from orion_kmer_tpu_torch.keys import keys_from_planes, u64_from_keys
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
