"""K4: ascending sort of up to ``MAX_SORT_N`` int64 keys by one cluster of
1 to 8 thread blocks (``csrc/sort.cu``).

Replaces ``orion_kmer_tpu/ops/sort_pallas.py::_sort_kernel``, reached
through ``_run_network`` from ``sort_pairs``.  The JAX entry sorts (hi, lo)
u32 pairs in u64 order; here a key is the flipped int64 of ``keys.py``, so
the same order is signed int64 order.  Like the JAX entry, ``sort_pairs``
hands sizes above ``MAX_SORT_N`` to the whole-array sort, here the radix
sort (``radix.sort_keys``), whose launches it does not count.
No command of the JAX package reaches this kernel; only its own entry does.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .radix import sort_keys

MAX_SORT_N = 1 << 14
launches = 0  # kernel launches since the last reset


def sort_pairs(keys):
    """``keys`` (1-d int64) sorted ascending: the K4 block sort on CUDA
    for 1 <= n <= MAX_SORT_N, ``sort_keys`` over all 64 bits above it; on
    the CPU, ``sort_keys``' plain version."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("sort_pairs: keys must be 1-d int64")
    if keys.device.type == "cpu":
        return sort_keys(keys)
    _kernels.require_cuda("sort_pairs", keys)
    n = keys.shape[0]
    if n > MAX_SORT_N:
        return sort_keys(keys)
    out = torch.empty_like(keys)
    if n == 0:
        return out
    global launches
    with _kernels.on_device(keys):
        _kernels.check(
            _kernels.lib().okt_sort(keys.data_ptr(), n, out.data_ptr(), _kernels.stream_ptr(keys)),
            "sort_pairs",
        )
    launches += 1
    return out
