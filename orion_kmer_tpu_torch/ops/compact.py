"""K3: stable compaction of kept elements over one or two int64 planes
(``csrc/compact.cu``).

Replaces ``orion_kmer_tpu/ops/sort_pallas.py::_compact_window_kernel``
and ``::_placement_kernel`` (``compact_left_pallas``).
"""

from __future__ import annotations

import torch

from .. import _kernels

launches = 0  # kernel launches since the last reset


def compact_plain(planes, keep):
    """Plain torch version of ``compact``: ``x[keep]``."""
    return [p[keep] for p in planes], keep.sum()


def compact(planes, keep):
    """Move the elements with ``keep`` set to the front, in order.

    planes: one or two int64 tensors of keep's length.  Returns (outs,
    n_kept): the first n_kept entries of each output are the kept
    elements (a CUDA output keeps its input length and leaves the tail
    unspecified; a CPU output is exactly n_kept long), and n_kept is a
    0-d int64 tensor on the same device."""
    if not 1 <= len(planes) <= 2:
        raise ValueError("compact: one or two planes")
    n = keep.shape[0]
    if keep.dtype != torch.bool:
        raise TypeError("compact: keep must be bool")
    if any(p.dtype != torch.int64 or p.shape != keep.shape for p in planes):
        raise TypeError("compact: planes must be int64 of keep's shape")
    if keep.device.type == "cpu":
        return compact_plain(planes, keep)
    _kernels.require_cuda("compact", keep, *planes)
    global launches
    lib = _kernels.lib()
    dev = keep.device
    counts = torch.empty(lib.okt_compact_blocks(n), dtype=torch.int64, device=dev)
    stream = _kernels.stream_ptr(keep)
    with _kernels.on_device(keep):
        _kernels.check(
            lib.okt_compact_count(keep.data_ptr(), n, counts.data_ptr(), stream),
            "compact (count)",
        )
    incl = torch.cumsum(counts, 0)
    offsets = incl - counts
    outs = [torch.empty_like(p) for p in planes]
    x1 = planes[1].data_ptr() if len(planes) == 2 else None
    o1 = outs[1].data_ptr() if len(planes) == 2 else None
    with _kernels.on_device(keep):
        _kernels.check(
            lib.okt_compact_scatter(
                keep.data_ptr(), n, planes[0].data_ptr(), x1, offsets.data_ptr(),
                outs[0].data_ptr(), o1, stream,
            ),
            "compact (scatter)",
        )
    launches += 1
    n_kept = incl[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    return outs, n_kept
