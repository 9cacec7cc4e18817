"""Streaming count accumulation over several shards: the sharded
DeviceCountTable.

The torch counterpart of ``orion_kmer_tpu/parallel/streaming.py``.  The
single-device pipeline (``table.DeviceCountTable``) generalizes to S
shards with the same stages:

  1. per batch, every shard extracts the canonical keys of its halo-split
     block (K1), splits them by hash-range owner (one K3 pass in route
     mode for all S destinations) and ships each destination its exact
     segment; every shard sorts what it received (``ops.radix.sort_keys``);
  2. each shard accumulates its sorted runs in its own merge forest (K2):
     a shard merges only its own hash range, so nothing crosses shards
     after the routing;
  3. at a flush each shard run-length encodes its range and folds it into
     its device-resident table (K3, K2); the host accumulator merges the
     shards' disjoint tables at a spill and at the end.

A shard is a ``table.DeviceCountTable`` on the shard's device: the JAX
package re-implements forest, flush, fold and spill on ``[S, cap]`` planes
because ``shard_map`` needs them; here a Python loop over the shards
does.  All k take one int64 key path: the JAX package's single-plane and
narrowed (u32, u16) routes save TPU interconnect bandwidth and are not
carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import CountAccumulator, _bucket
from ..table import DeviceCountTable
from .mesh import make_mesh
from .sharded import route_and_sort


class ShardedCountTable:
    """Streaming count accumulation over the shards of a mesh.

    The sharded analog of ``table.DeviceCountTable``: call ``update``
    per host batch, ``result`` once.  Every FLUSH_WINDOWS positions the
    shards flush their forests into their device tables, which bounds
    device memory as the single table does.
    """

    FLUSH_WINDOWS = DeviceCountTable.FLUSH_WINDOWS

    # Per-shard device-table spill bound (entries), the single table's.
    DEVICE_TABLE_MAX = DeviceCountTable.DEVICE_TABLE_MAX

    def __init__(self, k: int, mesh: list[torch.device] | None = None):
        self.k = k
        self.mesh = list(mesh) if mesh is not None else make_mesh()
        self.n_shards = len(self.mesh)
        self._shards = [DeviceCountTable(k, dev) for dev in self.mesh]
        for shard in self._shards:
            shard.DEVICE_TABLE_MAX = self.DEVICE_TABLE_MAX
        self._windows_since_flush = 0
        self._route = dict.fromkeys(
            ("positions", "updates", "route_dispatches", "route_retries",
             "a2a_bytes_sent", "a2a_bytes_ici", "recv_sort_elements"), 0
        )

    @property
    def stats(self) -> dict[str, int]:
        """Per-stage accounting, from exact lengths known on the host (no
        device fetch beyond the routed counts the exchange needs anyway).
        The keys are the JAX package's:

        positions, updates: input positions and ``update`` calls;
        route_dispatches: batches routed (route_retries stays 0: an
        exact-length exchange has nothing to retry);
        a2a_bytes_sent: 8 bytes for every key routed, whatever its
        destination; a2a_bytes_ici: the bytes that changed device (NVLink
        or PCIe between cards; 0 when the shards share one card);
        recv_sort_elements: keys through the receivers' sorts;
        merge_dispatches, merge_bytes, flush_dispatches, rle_elements,
        fold_dispatches, fold_elements, spills, host_link_bytes: the
        shards' forest merges, flush encodings, table folds and
        device-to-host spills, summed over the shards (a dispatch is one
        shard's)."""
        out = dict(self._route)
        for shard in self._shards:
            for key, n in shard.stats.items():
                out[key] = out.get(key, 0) + n
        return out

    def stats_report(self) -> dict:
        """``stats`` with the per-position traffic derived from it."""
        st = self.stats
        pos = max(st["positions"], 1)
        st["k"] = self.k
        st["n_shards"] = self.n_shards
        st["devices"] = [str(d) for d in self.mesh]
        st["route"] = "int64"
        st["a2a_bytes_per_position"] = round(st["a2a_bytes_sent"] / pos, 3)
        st["ici_bytes_per_position"] = round(st["a2a_bytes_ici"] / pos, 3)
        st["host_link_bytes_per_position"] = round(st["host_link_bytes"] / pos, 4)
        return st

    def warm(self) -> None:
        """Ready every distinct device of the mesh before the first real
        batch (each device once, however many shards share it): a scratch
        table with one shard per device takes small batches through
        routing, a forest merge, a flush and a table fold, so each kernel
        and torch op of the path, and the copies between devices, have run
        once.  This table stays empty."""
        scratch = ShardedCountTable(self.k, list(dict.fromkeys(self.mesh)))
        rng = np.random.default_rng(self.k)
        for step in range(3):
            scratch.update(rng.integers(0, 4, 1 << 14, dtype=np.uint8))
            if step == 1:
                scratch.flush()
        scratch.result()

    def update(self, codes: np.ndarray, invalid: np.ndarray | None = None):
        """Fold one batch of 2-bit codes in (255, or ``invalid``, marks
        positions no window may cover)."""
        n = codes.shape[0]
        if n == 0:
            return
        if invalid is None:
            invalid = codes > 3
        runs, table, moved = route_and_sort(codes, invalid, self.k, self.mesh)
        # the forest level follows the batch, not the received length (K2
        # takes any lengths), so the shards' forests stay in step
        level = _bucket(n)
        for shard, run in zip(self._shards, runs):
            shard.add_run(run, level)
        st = self._route
        routed = int(table.sum())
        st["positions"] += n
        st["updates"] += 1
        st["route_dispatches"] += 1
        st["a2a_bytes_sent"] += 8 * routed
        st["a2a_bytes_ici"] += moved
        st["recv_sort_elements"] += routed
        self._windows_since_flush += n
        if self._windows_since_flush >= self.FLUSH_WINDOWS:
            self.flush()

    def flush(self):
        for shard in self._shards:
            shard.flush()
        self._windows_since_flush = 0

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """Final (vals uint64, counts int64), value sorted.

        Each shard hands over its own sorted table (its spills and its
        last state merged); the shards' key sets are disjoint by
        ownership, so the host merge only interleaves them."""
        acc = CountAccumulator()
        for shard in self._shards:
            acc.add(*shard.result())
        return acc.result()
