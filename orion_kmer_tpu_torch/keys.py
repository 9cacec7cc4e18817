"""The port's key representation, and conversions from the JAX state.

A canonical k-mer is one ``torch.int64``: its u64 value XOR 2^63, so that
signed int64 order equals u64 order (torch has no ordered compare, shift
or searchsorted for uint64 on the CPU).  The all-ones SENTINEL maps to
``INT64_MAX``.  Validity is never inferred from the sentinel: every
stream carries its valid count explicitly.

The JAX package keeps keys as u32 planes: (hi, lo) for k >= 25, a
narrowed (t, b) pair for k = 17..24 and one lo plane for k <= 16.  The
functions here carry such state across, so tests can start the port and
the reference from the same table.
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = np.uint64(1 << 63)
SENTINEL_KEY = (1 << 63) - 1  # u64 all-ones, flipped


def keys_from_u64(vals: np.ndarray) -> torch.Tensor:
    """u64 numpy values -> flipped int64 tensor."""
    v = np.asarray(vals, dtype=np.uint64) ^ SIGN
    return torch.from_numpy(v.view(np.int64).copy())


def u64_from_keys(t: torch.Tensor) -> np.ndarray:
    """Flipped int64 tensor -> u64 numpy values (for the host accumulator
    and the native TSV writer)."""
    return t.detach().cpu().numpy().view(np.uint64) ^ SIGN


def keys_from_planes(hi: np.ndarray, lo: np.ndarray) -> torch.Tensor:
    """(hi, lo) u32 planes -> flipped int64 keys."""
    v = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
    return keys_from_u64(v)


def keys_from_u48(t: np.ndarray, b: np.ndarray, k: int) -> torch.Tensor:
    """(t, b) planes of the JAX k = 17..24 path -> flipped int64 keys
    (the widening of ``orion_kmer_tpu.ops.count.widen_u48_np``)."""
    b_bits = 2 * k - 32
    v = (np.asarray(t, np.uint64) << np.uint64(b_bits)) | np.asarray(b, np.uint64)
    return keys_from_u64(v)


def keys_from_single(lo: np.ndarray) -> torch.Tensor:
    """Single-plane (k <= 16) keys -> flipped int64 keys."""
    return keys_from_u64(np.asarray(lo, np.uint64))


def table_from_jax(planes, n: int, k: int):
    """A JAX ``DeviceCountTable._table`` (key planes..., cnt_lo, cnt_hi)
    with ``n`` live entries -> the port's (keys, counts, n): int64
    tensors of exactly ``n`` entries on the CPU."""
    planes = [np.asarray(p)[:n] for p in planes]
    *key_planes, clo, chi = planes
    if 2 * k <= 32:
        keys = keys_from_single(*key_planes)
    elif 2 * k <= 48:
        keys = keys_from_u48(*key_planes, k)
    else:
        keys = keys_from_planes(*key_planes)
    counts = (chi.astype(np.int64) << 32) | clo.astype(np.int64)
    return keys, torch.from_numpy(counts), n
