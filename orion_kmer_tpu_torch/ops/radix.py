"""Keys-only radix sort of int64 keys over the bits that can differ
(``csrc/radix.cu``): the port's sort of count's batches, of the sharded
counts' routed keys, of the sketch's hashes and of ``sort_pairs`` above
its cluster.

Replaces no Pallas kernel (the JAX package sorts with ``lax.sort``); on a
card it takes the place of ``torch.sort(keys).values``, which sorts (key,
index) pairs and drops the indices.  ``sort_keys`` has that call as its
plain version, the only path on the CPU.

``key_bits`` is what the caller can prove: that bits [0, key_bits) of the
keys alone decide their order.  K1's canonical keys (``keys.py``) are a
k-mer's u64 value with bit 63 flipped, zero from bit 2k to bit 62, and the
sentinel is INT64_MAX, all ones there.  A canonical value is never all ones
in its low 2k bits (the all-T k-mer's reverse complement, all-A, is the
smaller), so 2k bits put them in the order 64 do, the sentinels last.
"""

from __future__ import annotations

import torch

from .. import _kernels

MAX_N = (1 << 30) - 1  # the kernel's offsets are int32, its look-back counts 30 bits
_DIGIT_BITS = 9  # csrc/radix.cu's digit: 7 passes for the 62 bits of k = 31
launches = 0  # sorts launched since the last reset (one sort: memset, histogram, scan, passes)


def passes(key_bits: int) -> int:
    """Digit passes over bits [0, key_bits): the last writes the result."""
    return -(-key_bits // _DIGIT_BITS)


def sort_keys_plain(keys):
    """Plain torch version of ``sort_keys``: the library sort, values only."""
    return torch.sort(keys).values


def sort_keys(keys, key_bits: int = 64):
    """``keys`` (1-d int64) ascending, in a new tensor.  On a card, a radix
    sort of bits [0, key_bits), which the caller proves decide the order
    (the module's note).  A CPU tensor takes the plain version."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("sort_keys: keys must be 1-d int64")
    if not 1 <= key_bits <= 64:
        raise ValueError(f"sort_keys: key_bits must be in 1..64, got {key_bits}")
    if keys.device.type == "cpu":
        return sort_keys_plain(keys)
    _kernels.require_cuda("sort_keys", keys)
    n = keys.shape[0]
    if n > MAX_N:
        raise ValueError(f"sort_keys: at most {MAX_N} keys, got {n}")
    if n < 2:
        return keys.clone()
    n_passes = passes(key_bits)
    buf0 = torch.empty_like(keys)
    buf1 = torch.empty_like(keys) if n_passes > 1 else None
    lib = _kernels.lib()
    scratch = torch.empty(lib.okt_radix_scratch(n, key_bits) // 4, dtype=torch.int32, device=keys.device)
    with _kernels.on_device(keys):
        _kernels.check(
            lib.okt_radix_sort(
                keys.data_ptr(), buf0.data_ptr(), None if buf1 is None else buf1.data_ptr(), n,
                key_bits, scratch.data_ptr(), _kernels.stream_ptr(keys),
            ),
            "sort_keys",
        )
    global launches
    launches += 1
    return buf0 if n_passes % 2 else buf1
