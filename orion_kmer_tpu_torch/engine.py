"""Batched host -> device count pipeline on one device.

The torch counterpart of ``orion_kmer_tpu/engine.py``'s
``DeviceCountTable``, ``count_file`` and ``unique_from_file``.  The host
packs FASTA/FASTQ records into wire-format batches on a prefetch thread
(``host.py``) and stages them to the device; the device extracts and
sorts each batch into a raw run of canonical keys, accumulates runs in an
LSM merge forest, run-length encodes once per flush, and folds each
flush into a device-resident count table; the host sees data only when
the table spills or at the end.

Everything runs on the ``device`` the caller passes: CUDA tensors go
through the kernels of ``csrc/``, CPU tensors through their plain torch
versions.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from .host import (
    CountAccumulator,
    _bucket,
    _prefetch,
    default_batch,
    pack_for_transfer,
    stream_file_batches,
)
from .keys import u64_from_keys
from .ops.count import combine_sorted_unique, merge_runs, rle_sorted, sort_canonical_packed

logger = logging.getLogger("orion_kmer_tpu_torch.engine")


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A u32 wire array as an int32 tensor on ``device``: pinned and
    copied without blocking on CUDA, a zero-copy view on the CPU."""
    t = torch.from_numpy(arr.view(np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


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
        # capacity -> raw run (sorted keys, n_valid as a 0-d device tensor)
        self._runs: dict[int, tuple] = {}
        self._windows_since_flush = 0
        self._acc = CountAccumulator()
        # device-resident accumulated table: (keys, counts), exact length
        self._table: tuple | None = None

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
        of which the first n_windows are real)."""
        run = sort_canonical_packed(lanes, inv_words, self.k, n_windows)
        cap = size
        while cap in self._runs:
            run = merge_runs(self._runs.pop(cap), run)
            cap *= 2
        self._runs[cap] = run
        self._windows_since_flush += n_windows
        if self._windows_since_flush >= self.FLUSH_WINDOWS:
            self.flush()

    def _fold_into_table(self, keys, counts):
        """Merge one flush's RLE output into the device-resident table,
        spilling to the host accumulator at the capacity bound."""
        if self._table is None:
            self._table = (keys, counts)
            return
        t_keys, t_counts = self._table
        if t_keys.shape[0] + keys.shape[0] > self.DEVICE_TABLE_MAX:
            self._spill()
            self._table = (keys, counts)
            return
        self._table = combine_sorted_unique(t_keys, t_counts, keys, counts)

    def _spill(self):
        """Fetch the device table into the host accumulator and reset."""
        if self._table is None:
            return
        keys, counts = self._table
        if keys.shape[0]:
            self._acc.add(u64_from_keys(keys), counts.cpu().numpy())
        self._table = None

    def flush(self):
        for cap in sorted(self._runs):
            keys, n_valid = self._runs[cap]
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


def _staged_batches(path, k: int, normalize: bool, batch: int, device):
    """Parse, wire-pack and stage batches to the device; run on the
    prefetch thread, so the host-to-device copy is enqueued before the
    consumer needs the batch."""
    for pb in stream_file_batches(path, k, normalize=normalize, batch_positions=batch):
        n = pb.codes.shape[0]
        size = _bucket(n)
        lanes, inv_words = pack_for_transfer(pb.codes, size)
        yield to_device(lanes, device), to_device(inv_words, device), size, n


def count_file(
    path, k: int, device, normalize: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer counts of one file on ``device``: native parse ->
    prefetch (parse + pack + stage) -> device-resident accumulation ->
    one fetch.  Returns (u64 values ascending, int64 counts)."""
    device = torch.device(device)
    table = DeviceCountTable(k, device)
    positions = 0
    t0 = time.monotonic()
    last_log = t0
    batches = _staged_batches(path, k, normalize, default_batch(device), device)
    for lanes, inv_words, size, n in _prefetch(batches):
        table.update_packed(lanes, inv_words, size, n)
        positions += n
        now = time.monotonic()
        if now - last_log >= 30.0:
            logger.info(
                "count progress: %.1fM positions dispatched (%.1f s)",
                positions / 1e6,
                now - t0,
            )
            last_log = now
    return table.result()


def unique_from_file(path, k: int, device) -> np.ndarray:
    """Unique canonical k-mers of one genome file (build.rs:23-78)."""
    vals, _ = count_file(path, k, device)
    return vals
