"""K2: stable merge of two ascending int64 key runs in one launch
(``csrc/merge.cu``), in three modes.

- ``merge(a, b)``: the keys only (the merge forest, ``intersection_size``);
- ``merge(a, b, pa, pb)``: with an int64 payload (the joins);
- ``merge_combine(a, b, ca, cb)``: the fold of two sorted-unique counted
  tables: the merged keys, each count summed with an equal successor's,
  and the keep mask of the first of each key (``combine_sorted_unique``).

Replaces ``orion_kmer_tpu/ops/sort_pallas.py::_ce_fused_kernel`` and
``::_merge_tail_kernel``, and in the fold mode the elementwise tail of
``orion_kmer_tpu/ops/count.py::_combine_merged_unique``.  Runs may have
any lengths; on equal keys the elements of ``a`` come first.  Each mode
has its plain torch version beside it; a CPU tensor takes it, a CUDA
tensor takes the kernel, anything else raises.
"""

from __future__ import annotations

import math

import torch

from .. import _kernels

launches = 0  # kernel launches since the last reset
by_caller: dict[str, int] = {}  # the same launches by caller: forest, fold, join
by_size: dict[str, int] = {}  # and by caller and merged length, to the nearest power of two: "forest ~2^25"


def merge_plain(a, b, pa=None, pb=None):
    """Plain torch version of ``merge``: a stable sort of the
    concatenation, with the payload gathered by the sort's indices."""
    keys, idx = torch.sort(torch.cat([a, b]), stable=True)
    if pa is None:
        return keys, None
    return keys, torch.cat([pa, pb])[idx]


def combine_merged_plain(keys, cnt):
    """Plain torch version of the fold's epilogue, on merged keys in which
    each key appears at most twice: (summed, keep), where summed[i] =
    cnt[i] + cnt[i + 1] if keys[i + 1] == keys[i] else cnt[i], and
    keep[i] = i == 0 or keys[i] != keys[i - 1]."""
    eq_next = keys[1:] == keys[:-1]
    summed = cnt.clone()
    summed[:-1] += torch.where(eq_next, cnt[1:], 0)
    keep = torch.cat([eq_next.new_ones(min(keys.shape[0], 1)), ~eq_next])
    return summed, keep


def _check(name, a, b, pa, pb):
    if (pa is None) != (pb is None):
        raise ValueError(f"{name}: give both payloads or neither")
    operands = [a, b] + ([pa, pb] if pa is not None else [])
    if any(t.dtype != torch.int64 or t.dim() != 1 for t in operands):
        raise TypeError(f"{name}: operands must be 1-d int64")
    if pa is not None and (pa.shape != a.shape or pb.shape != b.shape):
        raise ValueError(f"{name}: a payload needs one value per key")
    return operands


def _launch(operands, with_payload: bool, with_keep: bool, caller: str):
    """One launch of okt_merge; returns (keys, payload or None, keep or None)."""
    a, b = operands[:2]
    _kernels.require_cuda("merge", *operands)
    na, nb = a.shape[0], b.shape[0]
    out = torch.empty(na + nb, dtype=torch.int64, device=a.device)
    pout = torch.empty_like(out) if with_payload else None
    keep = torch.empty(na + nb, dtype=torch.bool, device=a.device) if with_keep else None
    if na + nb == 0:
        return out, pout, keep  # nothing to merge, nothing to launch
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    pa, pb = (operands[2], operands[3]) if len(operands) == 4 else (None, None)
    with _kernels.on_device(a):
        _kernels.check(
            _kernels.lib().okt_merge(
                a.data_ptr(), na, b.data_ptr(), nb, ptr(pa), ptr(pb),
                out.data_ptr(), ptr(pout), ptr(keep), _kernels.stream_ptr(a),
            ),
            "merge",
        )
    global launches
    launches += 1
    by_caller[caller] = by_caller.get(caller, 0) + 1
    size = f"{caller} ~2^{round(math.log2(na + nb))}"
    by_size[size] = by_size.get(size, 0) + 1
    return out, pout, keep


def merge(a, b, pa=None, pb=None, *, caller: str = "other"):
    """Merge ascending runs ``a`` and ``b`` (int64).  With payloads
    ``pa``/``pb`` (int64, one per key) returns (keys, payload), else
    (keys, None).  ``caller`` names the launch in ``by_caller``."""
    operands = _check("merge", a, b, pa, pb)
    if a.device.type == "cpu":
        return merge_plain(a, b, pa, pb)
    keys, payload, _ = _launch(operands, pa is not None, False, caller)
    return keys, payload


def merge_combine(a, b, ca, cb):
    """The fold of two sorted-unique counted tables (keys ``a``, ``b``,
    int64 counts ``ca``, ``cb``): returns (keys, summed, keep) over the
    merged order, as ``merge`` then ``combine_merged_plain`` compute them;
    ``keys[keep]`` is the union and ``summed[keep]`` its counts."""
    operands = _check("merge_combine", a, b, ca, cb)
    if ca is None:
        raise ValueError("merge_combine: counts are required")
    if a.device.type == "cpu":
        keys, cnt = merge_plain(a, b, ca, cb)
        return (keys, *combine_merged_plain(keys, cnt))
    return _launch(operands, True, True, "fold")
