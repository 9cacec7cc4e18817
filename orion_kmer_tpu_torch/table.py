"""The device-resident count table: ``DeviceCountTable``, the torch
counterpart of the JAX package's, and the bounds that
``parallel.ShardedCountTable`` takes its own from."""

from __future__ import annotations

import os

import numpy as np
import torch

from . import _kernels
from .host import CountAccumulator, _bucket, pack_for_transfer
from .ops.count import combine_sorted_unique, merge_runs, rle_sorted, sort_canonical_packed
from .staging import fetch_table, to_device
from .utils import spans


class DeviceCountTable:
    """Device-resident count accumulation as an LSM-style merge forest.

    Each batch becomes a raw ascending weight-1 key run on the device;
    runs of equal capacity merge pairwise (K2) into a run of double
    capacity, binary-counter style, so every key takes part in
    O(log(total / batch)) merges.  Duplicates ride along until the flush,
    which run-length encodes each run once and folds it into the
    device-resident table; past DEVICE_TABLE_MAX entries the table spills
    to the host accumulator and restarts.
    """

    FLUSH_WINDOWS = 1 << 28

    # Device-table spill bound (entries of 16 B: key + count).
    DEVICE_TABLE_MAX = int(os.environ.get("ORION_KMER_DEVICE_TABLE_MAX", str(1 << 27)))

    def __init__(self, k: int, device):
        self.k = k
        self.device = torch.device(device)
        # forest level -> raw run (sorted keys, n_valid as a 0-d device tensor)
        self._runs: dict[int, tuple] = {}
        self._windows_since_flush = 0
        self._acc = CountAccumulator()
        # device-resident accumulated table: (keys, counts), exact length
        self._table: tuple | None = None
        # launches and exact element counts per stage, from host-side
        # lengths alone (no device fetch); ``ShardedCountTable.stats`` sums
        # them over its shards
        self.stats = dict.fromkeys(
            ("merge_dispatches", "merge_bytes", "flush_dispatches", "rle_elements",
             "fold_dispatches", "fold_elements", "spills", "host_link_bytes"), 0
        )

    def update(self, codes: np.ndarray):
        """Fold one batch of 2-bit codes (255 = invalid) in."""
        n = codes.shape[0]
        if n == 0:
            return
        size = _bucket(n)
        lanes, inv_words = pack_for_transfer(codes, size)
        self.update_packed(
            to_device(lanes, self.device), to_device(inv_words, self.device), size, n
        )

    def update_packed(self, lanes, inv_words, size: int, n_windows: int):
        """Fold one wire-format batch in (size = 16 * len(lanes) positions,
        of which the first n_windows are real), under an ``engine.update``
        span: the host's cost of enqueueing a batch."""
        with spans.span("engine.update"):
            self.add_run(sort_canonical_packed(lanes, inv_words, self.k, n_windows), size)
            self._windows_since_flush += n_windows
            if self._windows_since_flush >= self.FLUSH_WINDOWS:
                self.flush()

    def add_run(self, run, level: int):
        """Add one ready raw run (ascending keys on this device, n_valid)
        to the forest at ``level``, the batch's bucket: runs of one level
        merge (K2, any lengths) into the next, binary-counter style.  The
        caller decides when to flush."""
        while level in self._runs:
            prev = self._runs.pop(level)
            self.stats["merge_dispatches"] += 1
            self.stats["merge_bytes"] += 8 * (prev[0].shape[0] + run[0].shape[0])
            run = merge_runs(prev, run)
            level *= 2
        self._runs[level] = run

    def _fold_into_table(self, keys, counts):
        """Merge one flush's RLE output into the device-resident table,
        spilling to the host accumulator at the capacity bound."""
        self.stats["fold_dispatches"] += 1
        if self._table is not None and self._table[0].shape[0] + keys.shape[0] > self.DEVICE_TABLE_MAX:
            self._spill()
        if self._table is None:
            self.stats["fold_elements"] += keys.shape[0]
            self._table = (keys, counts)
            return
        t_keys, t_counts = self._table
        self.stats["fold_elements"] += t_keys.shape[0] + keys.shape[0]
        self._table = combine_sorted_unique(t_keys, t_counts, keys, counts)

    def _spill(self):
        """Fetch the device table into the host accumulator and reset."""
        if self._table is None:
            return
        keys, counts = self._table
        self.stats["spills"] += 1
        self.stats["host_link_bytes"] += 16 * keys.shape[0]
        if keys.shape[0]:
            self._acc.add(*fetch_table(keys, counts))
        self._table = None

    def flush(self):
        with spans.span("engine.flush"):
            for cap in sorted(self._runs):
                keys, n_valid = self._runs[cap]
                self.stats["flush_dispatches"] += 1
                self.stats["rle_elements"] += keys.shape[0]
                ukeys, ucnt = rle_sorted(keys, n_valid)
                if ukeys.shape[0]:
                    self._fold_into_table(ukeys, ucnt)
            self._runs = {}
            self._windows_since_flush = 0

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """(u64 values ascending, int64 counts) of everything folded in."""
        self.flush()
        self._spill()
        return self._acc.result()

    def warm(self) -> None:
        """Ready the device for this k before the first real batch: load
        the kernel library (an nvcc build on a fresh checkout) and run one
        small batch through a scratch table, so each kernel and torch op of
        the path has been loaded and launched once.  This table stays
        empty."""
        if self.device.type == "cuda":
            _kernels.lib()
        scratch = DeviceCountTable(self.k, self.device)
        rng = np.random.default_rng(self.k)
        scratch.update(rng.integers(0, 4, 1 << 16, dtype=np.uint8))
        scratch.result()
