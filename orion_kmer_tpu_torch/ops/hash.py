"""64-bit hashes of the port's keys: splitmix64 (FracMinHash sketching)
and mix32 with the owner it gives (hash-range shard routing).

The torch counterparts of ``orion_kmer_tpu/ops/hash.py``'s
``splitmix64_pair`` and ``mix32_pair``, in native 64-bit arithmetic: the
JAX package's (hi, lo) u32 limbs exist only because TPUs have no 64-bit
integer lanes.  The numpy oracles ``splitmix64_np`` and ``mix32_np`` are
the port's own copies.

torch has no unsigned 64-bit arithmetic on the CPU, so the work is done
in int64: additions and products wrap mod 2^64 as in u64, and every right
shift masks off the bits that int64's arithmetic shift copies from the
sign.  Keys arrive flipped (u64 XOR 2^63, ``keys.py``) and are unflipped
before hashing; splitmix64 returns its hash flipped again, so that signed
order is the hash's u64 order.
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)  # 2^63 as an int64 bit pattern
M32 = 0xFFFFFFFF


def _i64(c: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_SM_ADD = _i64(0x9E3779B97F4A7C15)
_SM_C1 = _i64(0xBF58476D1CE4E5B9)
_SM_C2 = _i64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(keys: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer of flipped int64 keys -> flipped int64 hashes
    (u64 hash XOR 2^63), on the keys' device."""
    z = (keys ^ SIGN) + _SM_ADD
    z = (z ^ _shr(z, 30)) * _SM_C1
    z = (z ^ _shr(z, 27)) * _SM_C2
    return z ^ _shr(z, 31) ^ SIGN


def mix32(keys: torch.Tensor) -> torch.Tensor:
    """Fast 32-bit mix of flipped int64 keys for hash-range shard routing;
    the u32 results as int64 in [0, 2^32)."""
    x = keys ^ SIGN
    hi, lo = _shr(x, 32), x & M32
    x = ((hi * 0x85EBCA6B) ^ (lo * 0xC2B2AE35)) & M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def owner_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The owner shard of each flipped int64 key, from the top 16 bits of
    its mix32 hash: floor(h / 2^16 * S / 2^16), uniform for any S.  The
    same formula as the JAX package's ``_owner_of``, so the two packages
    place every k-mer on the same shard; K3's route computes it in
    registers (``csrc/compact.cu``)."""
    return ((mix32(keys) >> 16) * n_shards) >> 16


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Host oracle: splitmix64 finalizer on numpy uint64."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def mix32_np(vals: np.ndarray) -> np.ndarray:
    """Host oracle for mix32 on uint64 inputs."""
    vals = np.asarray(vals, dtype=np.uint64)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    lo = vals.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = hi * np.uint32(0x85EBCA6B) ^ lo * np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
        x = x * np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x = x * np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x
