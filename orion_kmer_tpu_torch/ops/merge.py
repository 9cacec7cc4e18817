"""K2: stable merge of two ascending int64 key runs, with an optional
int64 payload (``csrc/merge.cu``).

Replaces ``orion_kmer_tpu/ops/sort_pallas.py::_ce_fused_kernel`` and
``::_merge_tail_kernel``.  Runs may have any lengths; on equal keys the
elements of ``a`` come first.
"""

from __future__ import annotations

import torch

from .. import _kernels

launches = 0  # kernel launches since the last reset


def merge_plain(a, b, pa=None, pb=None):
    """Plain torch version of ``merge``: a stable sort of the
    concatenation, with the payload gathered by the sort's indices."""
    keys, idx = torch.sort(torch.cat([a, b]), stable=True)
    if pa is None:
        return keys, None
    return keys, torch.cat([pa, pb])[idx]


def merge(a, b, pa=None, pb=None):
    """Merge ascending runs ``a`` and ``b`` (int64).  With payloads
    ``pa``/``pb`` (int64, one per key) returns (keys, payload), else
    (keys, None)."""
    if (pa is None) != (pb is None):
        raise ValueError("merge: give both payloads or neither")
    operands = [a, b] + ([pa, pb] if pa is not None else [])
    if any(t.dtype != torch.int64 or t.dim() != 1 for t in operands):
        raise TypeError("merge: operands must be 1-d int64")
    if pa is not None and (pa.shape != a.shape or pb.shape != b.shape):
        raise ValueError("merge: a payload needs one value per key")
    if a.device.type == "cpu":
        return merge_plain(a, b, pa, pb)
    _kernels.require_cuda("merge", *operands)
    global launches
    lib = _kernels.lib()
    na, nb = a.shape[0], b.shape[0]
    out = torch.empty(na + nb, dtype=torch.int64, device=a.device)
    pout = torch.empty_like(out) if pa is not None else None
    split = torch.empty(
        lib.okt_merge_scratch(na + nb), dtype=torch.int64, device=a.device
    )
    _kernels.check(
        lib.okt_merge(
            a.data_ptr(), na, b.data_ptr(), nb,
            pa.data_ptr() if pa is not None else None,
            pb.data_ptr() if pb is not None else None,
            split.data_ptr(), out.data_ptr(),
            pout.data_ptr() if pout is not None else None,
            _kernels.stream_ptr(a),
        ),
        "merge",
    )
    launches += 1
    return out, pout
