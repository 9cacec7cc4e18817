"""Hash-range-sharded k-mer counting: ownership, routing and the one-shot
sharded count.

The torch counterpart of ``orion_kmer_tpu/parallel/sharded.py``.  Step
layout:

  1. the batch is cut into one block per shard, with a (k-1) halo, so
     every window is produced by exactly one block (data parallelism:
     each shard extracts its block's canonical keys with K1);
  2. each key goes to its owner shard, the owner being a range of the
     ``mix32`` hash space (the table axis): one K3 pass in route mode
     splits a block S ways and returns the exact count of keys for each
     destination;
  3. each owner sorts and run-length encodes what it received; the
     shards' outputs are disjoint, so no second reduction is needed.

The exchange ships segments of exact length.  The JAX package's
per-destination capacity, its overflow flag, the doubled-capacity retry
and the all-gather fallback guard static shapes and have no counterpart
here: a skewed batch is exact in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..keys import u64_from_keys
from ..ops.compact import partition
from ..ops.count import rle_sorted


def shard_blocks(codes: np.ndarray, invalid: np.ndarray, k: int, n_shards: int):
    """Split a packed stream into S equal blocks with (k-1) halos.

    Blocks overlap by k-1 positions so that a window crossing a block
    boundary is produced by exactly one block: the left one, whose halo
    completes it; the right block's first window starts at its own first
    position.  Returns (codes u8[S * block], invalid bool[S * block],
    block); positions past the stream's end are invalid."""
    n = codes.shape[0]
    halo = k - 1
    base = -(-n // n_shards)  # payload per shard
    block = base + halo
    out_codes = np.zeros((n_shards, block), dtype=np.uint8)
    out_invalid = np.ones((n_shards, block), dtype=bool)
    for s in range(n_shards):
        start = s * base
        stop = min(start + block, n)
        if start < n:
            span = stop - start
            out_codes[s, :span] = codes[start:stop]
            out_invalid[s, :span] = invalid[start:stop]
    return out_codes.reshape(-1), out_invalid.reshape(-1), block


def route_to_owners(keys: torch.Tensor, n_shards: int) -> list[torch.Tensor]:
    """``ops.compact.partition`` (the route: one K3 pass) with the counts
    fetched (one transfer): per destination shard, the segment of exactly
    the keys it owns."""
    bufs, counts = partition(keys, n_shards)
    return [buf[:m] for buf, m in zip(bufs, counts.tolist())]


def fetch_counts(counts: list[torch.Tensor], mesh: list[torch.device]) -> np.ndarray:
    """The table of routed counts (row = source shard of ``mesh``, column
    = destination shard) from the per-source count vectors of
    ``ops.compact.partition``: one transfer per distinct device, made after every
    shard's work has been enqueued.  S x S for a mesh that holds every
    shard; a process's rows of the global table for a part of it."""
    table = np.empty((len(mesh), counts[0].shape[0]), dtype=np.int64)
    by_device: dict[torch.device, list[int]] = {}
    for s, dev in enumerate(mesh):
        by_device.setdefault(dev, []).append(s)
    for sources in by_device.values():
        table[sources] = torch.stack([counts[s] for s in sources]).cpu().numpy()
    return table


def exchange(bufs: list[list[torch.Tensor]], table: np.ndarray, mesh: list[torch.device]):
    """Hand every destination shard its keys: ``bufs[s][d][:table[s, d]]``
    of every source s, copied to ``mesh[d]`` and concatenated.

    torch's cross-device copy orders the source's and the destination's
    current streams around itself, and a same-device ``to`` is no copy at
    all; the source buffers stay referenced until every ``cat`` has been
    enqueued.  Returns the received tensors and the bytes that changed
    device."""
    received, moved = [], 0
    for d, dev in enumerate(mesh):
        segments = []
        for s, src in enumerate(mesh):
            seg = bufs[s][d][: int(table[s, d])]
            if src != dev:
                moved += 8 * seg.shape[0]
                seg = seg.to(dev, non_blocking=True)
            segments.append(seg)
        received.append(torch.cat(segments))
    return received, moved


def _assemble(parts: list[tuple[torch.Tensor, torch.Tensor]]):
    """Per-shard (unique keys, counts) -> (vals u64, counts int64), value
    sorted.  The shards' key sets are disjoint by ownership."""
    vals = np.concatenate([u64_from_keys(keys) for keys, _ in parts])
    counts = np.concatenate([cnt.cpu().numpy() for _, cnt in parts])
    order = np.argsort(vals, kind="stable")
    return vals[order], counts[order]


def sharded_count(codes: np.ndarray, invalid: np.ndarray, k: int, mesh=None):
    """Canonical k-mer count of one packed stream over the shards of
    ``mesh`` (by default one per visible card).

    Exactness: block halos produce each window once; hash ownership counts
    each distinct k-mer on exactly one shard; the exchange is of exact
    lengths.  Returns (vals uint64, counts int64), value sorted."""
    from .mesh import make_mesh
    from .streaming import route_and_sort

    if mesh is None:
        mesh = make_mesh()
    runs, _, _ = route_and_sort(codes, invalid, k, mesh)
    return _assemble([rle_sorted(keys, n_valid) for keys, n_valid in runs])
