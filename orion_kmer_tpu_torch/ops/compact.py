"""K3: stable compaction in one pass (``csrc/compact.cu``), in three modes.

- ``compact(planes, keep)``: the kept elements of one or two int64 planes,
  in order;
- ``compact_positions(keys, keep, limit)``: the kept keys and their own
  indices, which the kernel writes without reading a position plane;
- ``partition(keys, n_dest)``: every key on the row of its owner among
  ``n_dest`` destinations (``hash.owner_of``), in position order, the
  sentinel dropped: the sharded count's route, one launch for all rows.

Replaces ``orion_kmer_tpu/ops/sort_pallas.py::_compact_window_kernel`` and
``::_placement_kernel`` (``compact_left_pallas``), and the JAX route's
sort-compact-merge split by owner (``parallel/sharded.py::route_to_owners``).
Each mode has its plain torch version beside it; a CPU tensor takes it,
a CUDA tensor takes the kernel, anything else raises.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..keys import SENTINEL_KEY
from .hash import owner_of

launches = 0  # kernel launches since the last reset
by_mode: dict[str, int] = {}  # the same launches by mode: one plane, two planes, positions, route


def compact_plain(planes, keep):
    """Plain torch version of ``compact``: ``x[keep]``."""
    return [p[keep] for p in planes], keep.sum()


def compact_positions_plain(keys, keep, limit=None):
    """Plain torch version of ``compact_positions``: ``arange`` and
    ``[keep]``."""
    idx = torch.arange(keys.shape[0], device=keys.device)
    if limit is not None:
        keep = keep & (idx < limit)
    return [keys[keep], idx[keep]], keep.sum()


def partition_plain(keys, n_dest: int):
    """Plain torch version of ``partition``: the owners, one mask per
    destination and ``keys[mask]``."""
    valid = keys != SENTINEL_KEY
    owner = owner_of(keys, n_dest)
    masks = [valid & (owner == d) for d in range(n_dest)]
    return [keys[m] for m in masks], torch.stack([m.sum() for m in masks])


def _check_keep(name, keep, planes):
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError(f"{name}: keep must be a 1-d bool tensor")
    if any(p.dtype != torch.int64 or p.shape != keep.shape for p in planes):
        raise TypeError(f"{name}: planes must be int64 of keep's shape")


def _workspace(lib, n: int, n_dest: int, device):
    """The kernel's zeroed workspace (ticket, counts, status words); its
    words 1 .. n_dest receive the counts."""
    return torch.zeros(lib.okt_compact_workspace(n, n_dest), dtype=torch.int64, device=device)


def _counted(n: int, mode: str) -> None:
    global launches
    if n:  # the kernel launches for a non-empty input only
        launches += 1
        by_mode[mode] = by_mode.get(mode, 0) + 1


def _compact_on_card(name, keep, limit, x0, x1, positions: bool):
    """Mask and positions modes on the card: one launch of okt_compact."""
    operands = [t for t in (keep, x0, x1, limit) if t is not None]
    _kernels.require_cuda(name, *operands)
    lib = _kernels.lib()
    n = keep.shape[0]
    outs = [torch.empty_like(x0) for _ in range(2 if x1 is not None or positions else 1)]
    ws = _workspace(lib, n, 1, keep.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with _kernels.on_device(keep):
        _kernels.check(
            lib.okt_compact(
                keep.data_ptr(), ptr(limit), n, x0.data_ptr(), ptr(x1), int(positions),
                outs[0].data_ptr(), outs[1].data_ptr() if len(outs) == 2 else None, ws.data_ptr(),
                _kernels.stream_ptr(keep),
            ),
            name,
        )
    _counted(n, "positions" if positions else "two planes" if x1 is not None else "one plane")
    return outs, ws[1]


def compact(planes, keep):
    """Move the elements with ``keep`` set to the front, in order.

    planes: one or two int64 tensors of keep's length.  Returns (outs,
    n_kept): the first n_kept entries of each output are the kept
    elements (a CUDA output keeps its input length and leaves the tail
    unspecified; a CPU output is exactly n_kept long), and n_kept is a
    0-d int64 tensor on the same device."""
    if not 1 <= len(planes) <= 2:
        raise ValueError("compact: one or two planes")
    _check_keep("compact", keep, planes)
    if keep.device.type == "cpu":
        return compact_plain(planes, keep)
    return _compact_on_card("compact", keep, None, planes[0], planes[1] if len(planes) == 2 else None, False)


def compact_positions(keys, keep, limit=None):
    """``compact([keys, arange(n)], keep & (arange(n) < limit))`` without
    the arange: the kernel writes each kept element's index.

    limit: None, or a 0-d int64 tensor on keys' device (no host sync).
    Returns ((kept keys, their indices), n_kept) as ``compact`` does."""
    _check_keep("compact_positions", keep, [keys])
    if limit is not None and (limit.dtype != torch.int64 or limit.dim() != 0 or limit.device != keys.device):
        raise TypeError("compact_positions: limit must be a 0-d int64 tensor on keys' device")
    if keep.device.type == "cpu":
        return compact_positions_plain(keys, keep, limit)
    return _compact_on_card("compact_positions", keep, limit, keys, None, True)


def partition(keys, n_dest: int):
    """Split int64 keys by owner (``hash.owner_of``) among ``n_dest``
    destinations, dropping SENTINEL_KEY, without waiting for the device.

    Returns (bufs, counts): ``bufs[d]`` starts with the keys that
    destination d owns, in position order (a CUDA row keeps the input's
    length and leaves its tail unspecified; a CPU row is exact), and
    ``counts`` is int64[n_dest] on keys' device."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("partition: keys must be a 1-d int64 tensor")
    if n_dest < 1:
        raise ValueError(f"partition: n_dest must be >= 1, got {n_dest}")
    if keys.device.type == "cpu":
        return partition_plain(keys, n_dest)
    _kernels.require_cuda("partition", keys)
    lib = _kernels.lib()
    n = keys.shape[0]
    out = torch.empty((n_dest, n), dtype=torch.int64, device=keys.device)
    ws = _workspace(lib, n, n_dest, keys.device)
    with _kernels.on_device(keys):
        _kernels.check(
            lib.okt_compact_route(keys.data_ptr(), n, n_dest, out.data_ptr(), ws.data_ptr(), _kernels.stream_ptr(keys)),
            "partition",
        )
    _counted(n, "route")
    return list(out.unbind(0)), ws[1 : 1 + n_dest]
