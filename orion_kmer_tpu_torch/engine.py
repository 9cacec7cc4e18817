"""Batched host -> device pipelines: counting (on one device, or over
several shards through ``parallel/``) and the set joins.

The torch counterpart of ``orion_kmer_tpu/engine.py``'s
``DeviceCountTable``, ``count_file``, ``unique_from_file``,
``query_file``/``query_records``, ``ClassifyJoiner`` and
``intersection_size_host``, plus ``query_hits``, the per-read hit counts
under ``query_file``, ``query_lines``, its ids as the query command
writes them, and ``staged_batches``, which ``count_file`` and
``commands.sketch.sketch_file`` share.  For counting, the host
packs FASTA/FASTQ records into wire-format batches on a prefetch thread
(``host.py``) and stages them to the device; the device extracts and
sorts each batch into a raw run of canonical keys, accumulates runs in an
LSM merge forest, run-length encodes once per flush, and folds each
flush into a device-resident count table; the host sees data only when
the table spills or at the end.  ``query_file`` streams its batches the
same way (``query_batches``) and reads each batch's per-read hits one
batch late.

Everything runs on the ``device`` the caller passes: CUDA tensors go
through the kernels of ``csrc/``, CPU tensors through their plain torch
versions.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, NamedTuple

import numpy as np
import torch

from . import _kernels
from .errors import ContextError
from .host import (
    CountAccumulator,
    _bucket,
    _prefetch,
    _rebatch_records,
    batch_for,
    iter_packed_batches,
    native_chunks,
    pack_for_transfer,
    parse_threads,
    stream_file_codes,
)
from .ingest import native
from .ingest.fastx import FastxParseError, Record, parse_fastx_file
from .keys import keys_from_u64, u64_from_keys
from .ops import setops
from .ops.count import combine_sorted_unique, merge_runs, rle_sorted, sort_canonical_packed
from .ops.extract import extract_keys

logger = logging.getLogger("orion_kmer_tpu_torch.engine")

_SIGN_BIT = -(1 << 63)  # the flip of ``keys``' int64 order to u64 order


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A u32 wire array as an int32 tensor on ``device``: pinned and
    copied without blocking on CUDA, a zero-copy view on the CPU."""
    t = torch.from_numpy(arr.view(np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def fetch_table(keys: torch.Tensor, counts: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A count table's (flipped int64 keys, int64 counts) tensors -> (u64
    values, int64 counts) on the host.

    On a card the sign bit is flipped there, and both planes are copied
    without blocking into pinned host memory, in flight at once, with one
    synchronisation; the arrays returned own that memory.  A CPU tensor
    takes the plain path: ``u64_from_keys`` and the counts' own memory."""
    if keys.device.type == "cpu":
        return u64_from_keys(keys), counts.numpy()
    if keys.device.type != "cuda":
        raise ValueError(f"fetch_table: tensors on {keys.device}, not cpu or cuda")
    host_keys = torch.empty(keys.shape, dtype=torch.int64, pin_memory=True)
    host_counts = torch.empty(counts.shape, dtype=torch.int64, pin_memory=True)
    host_keys.copy_(keys ^ _SIGN_BIT, non_blocking=True)
    host_counts.copy_(counts, non_blocking=True)
    torch.cuda.current_stream(keys.device).synchronize()
    return host_keys.numpy().view(np.uint64), host_counts.numpy()


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
        of which the first n_windows are real)."""
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


class PinnedRing:
    """A few pinned host buffers that wire batches (and a query batch's
    record starts) are packed straight into and copied from without
    blocking; a buffer is packed again only once the copy that last read
    it has completed (its CUDA event).  A batch is packed in ``parts``
    slices of whole wire words at once (the parser threads, -t), on
    threads of the ring's own: the native packer releases the GIL."""

    SLOTS = 3

    def __init__(self, device: torch.device, parts: int = 1):
        from concurrent.futures import ThreadPoolExecutor

        self.device = device
        self.parts = parts
        self._slots: list = [None] * self.SLOTS
        self._next = 0
        self._pool = ThreadPoolExecutor(parts, thread_name_prefix="okt-pack") if parts > 1 else None

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def _pack(self, codes: np.ndarray, size: int, lanes: np.ndarray, inv: np.ndarray) -> None:
        if self._pool is None:
            pack_for_transfer(codes, size, out=(lanes, inv))
            return
        # slice edges on multiples of 32 positions: one invalid word, two lanes
        step = -(-size // (32 * self.parts)) * 32
        parts = [
            self._pool.submit(
                pack_for_transfer, codes[lo : lo + step], min(step, size - lo),
                (lanes[lo // 16 : (lo + step) // 16], inv[lo // 32 : (lo + step) // 32]),
            )
            for lo in range(0, size, step)
        ]
        for f in parts:
            f.result()

    def stage(self, codes: np.ndarray, size: int, starts: np.ndarray | None = None):
        """Pack ``codes`` at wire size ``size`` into the next buffer and
        start its copy to the device: (lanes, invalid words) there, and
        ``starts`` (int64) copied beside them when given."""
        i = self._next
        self._next = (i + 1) % self.SLOTS
        slot = self._slots[i]
        if slot is not None:
            slot[2].synchronize()
        if slot is None or slot[0].shape[0] < size // 16:
            slot = self._slots[i] = [
                torch.empty(size // 16, dtype=torch.int32, pin_memory=True),
                torch.empty(size // 32, dtype=torch.int32, pin_memory=True),
                torch.cuda.Event(),
                None if slot is None else slot[3],
            ]
        lanes, inv, done = slot[0][: size // 16], slot[1][: size // 32], slot[2]
        self._pack(codes, size, lanes.numpy().view(np.uint32), inv.numpy().view(np.uint32))
        staged = lanes.to(self.device, non_blocking=True), inv.to(self.device, non_blocking=True)
        if starts is not None:
            m = starts.shape[0]
            if slot[3] is None or slot[3].shape[0] < m:
                slot[3] = torch.empty(_bucket(m), dtype=torch.int64, pin_memory=True)
            slot[3].numpy()[:m] = starts
            staged += (slot[3][:m].to(self.device, non_blocking=True),)
        done.record(torch.cuda.current_stream(self.device))
        return staged


def staged_batches(path, k: int, normalize: bool, batch: int, device):
    """Parse, wire-pack and stage batches to the device; run on the
    prefetch thread, so the host-to-device copy is enqueued before the
    consumer needs the batch.  On CUDA the batches are packed into a
    ``PinnedRing``; on the CPU the tensors are views of the packed
    arrays."""
    ring = PinnedRing(device, parse_threads()) if device.type == "cuda" else None
    try:
        for codes in stream_file_codes(path, k, normalize, batch):
            n = codes.shape[0]
            size = _bucket(n)
            if ring is None:
                lanes, inv_words = pack_for_transfer(codes, size)
                yield to_device(lanes, device), to_device(inv_words, device), size, n
            else:
                yield *ring.stage(codes, size), size, n
    finally:
        if ring is not None:
            ring.close()


def _make_count_table(k: int, device):
    """The count table for ``device``: ``DeviceCountTable`` on one device,
    ``parallel.ShardedCountTable`` over several shards.

    ``ORION_KMER_SHARDS``: ``N`` > 1 = N logical shards, round-robin over
    the visible cards when ``device`` is ``cuda`` (on a CPU device, N CPU
    shards: what the tests run); ``auto`` (the default), ``0`` or ``1`` =
    the single table on ``device``.  ``auto`` is the single table because
    one consumer thread cuts, packs and launches for every shard: on four
    NVIDIA H100 80GB HBM3 cards at 700 W, `count -k 31 -m 2 --histogram`
    of 0.5 Gbp took 8.109 s over four shards, one a card, against 6.287 s
    for the single table (``chip_smoke.py`` phase 10).  ``auto`` turns
    back to one shard per card once four cards win that measurement."""
    device = torch.device(device)
    mode = os.environ.get("ORION_KMER_SHARDS", "auto")
    n_shards = int(mode) if mode.isdigit() else 0
    if n_shards > 1:
        from .parallel import ShardedCountTable, make_mesh

        if device.type == "cuda" and device.index is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [device]
        return ShardedCountTable(k, make_mesh(n_shards, devices))
    return DeviceCountTable(k, device)


def count_file(
    path, k: int, device, normalize: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer counts of one file on ``device``: native parse ->
    prefetch (parse + pack + stage) -> device-resident accumulation ->
    one fetch.  Spread over several shards when ``_make_count_table`` says
    so.  Returns (u64 values ascending, int64 counts)."""
    device = torch.device(device)
    table = _make_count_table(k, device)
    batch = batch_for(k, device)
    if isinstance(table, DeviceCountTable):
        batches = staged_batches(path, k, normalize, batch, device)

        def fold(staged) -> int:
            table.update_packed(*staged)
            return staged[3]

    else:
        # the sharded table cuts, packs and stages each batch itself
        batches = stream_file_codes(path, k, normalize, batch)

        def fold(codes) -> int:
            table.update(codes)
            return codes.shape[0]

    positions = 0
    t0 = time.monotonic()
    last_log = t0
    for item in _prefetch(batches):
        positions += fold(item)
        now = time.monotonic()
        if now - last_log >= 30.0:
            logger.info(
                "count progress: %.1fM positions dispatched (%.1f s)",
                positions / 1e6,
                now - t0,
            )
            last_log = now
    result = table.result()
    if not isinstance(table, DeviceCountTable):
        logger.info("sharded count: %s", table.stats_report())
    return result


def unique_from_file(path, k: int, device) -> np.ndarray:
    """Unique canonical k-mers of one genome file (build.rs:23-78)."""
    vals, _ = count_file(path, k, device)
    return vals


def _db_on_device(db_vals: np.ndarray, device) -> torch.Tensor:
    """Sorted unique u64 values -> flipped int64 keys on ``device``."""
    return keys_from_u64(db_vals).to(device)


def _batch_hits(lanes, inv_words, size: int, n: int, starts, db_keys, k: int):
    """Per-record window hits of one staged query batch, as an int64
    tensor on its device; no device value is read.

    lanes, inv_words: the batch's wire format (``size`` positions, the
    first ``n`` real); starts: int64, the ascending batch-local start of
    each record's region, clamped at 0 (a record's region runs to the next
    start, its separator included).  The windows are extracted (K1) in
    position order and sorted with their positions, and the whole sorted
    batch is joined with the DB (K2): invalid windows hold SENTINEL_KEY,
    which sorts last, and their positions go to the join's spare slot, so
    none is a member, not even of a DB that holds the sentinel's value
    (T^32 at k = 32).  The hits of a record are a difference of prefix
    sums over the member positions."""
    keys, n_valid = extract_keys(lanes, inv_words, k, n)
    skeys, order = torch.sort(keys)
    valid = torch.arange(size, device=keys.device) < n_valid
    member = setops.member_positions(db_keys, skeys, torch.where(valid, order, size), size)
    prefix = torch.zeros(size + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(member, 0, out=prefix[1:])
    hi = torch.cat([starts[1:], starts.new_full((1,), size)])
    return prefix[hi] - prefix[starts]


def _staged_plain(piece: np.ndarray, starts: np.ndarray, device):
    """One query batch packed and copied to ``device`` without a ring:
    (lanes, invalid words, size, n, starts clamped at 0)."""
    n = piece.shape[0]
    size = -(-n // 32) * 32
    lanes, inv_words = pack_for_transfer(piece, size)
    lo = torch.from_numpy(np.maximum(starts, 0).astype(np.int64)).to(device)
    return to_device(lanes, device), to_device(inv_words, device), size, n, lo


def _records_hits(db_keys, records: list[Record], k: int, device) -> np.ndarray:
    """Per-record window hits of parsed records (raw bytes, no
    normalization), in memory."""
    hits = np.zeros(len(records), dtype=np.int64)
    for pb in iter_packed_batches(
        records, k, normalize=False, batch_positions=batch_for(k, device), with_owner=True
    ):
        nr = len(pb.record_ids)
        starts = np.searchsorted(pb.owner, np.arange(nr))
        batch_hits = _batch_hits(*_staged_plain(pb.codes, starts, device), db_keys, k)
        np.add.at(hits, pb.first_rid + np.arange(nr), batch_hits.cpu().numpy())
    return hits


def _passing(ids, lens, hits: np.ndarray, k: int, min_hits: int) -> list[bytes]:
    """IDs of reads with >= min_hits hits; reads shorter than k never match."""
    return [i for i, n, h in zip(ids, lens, hits.tolist()) if h >= min_hits and n >= k]


def query_records(
    db_vals: np.ndarray, records: Iterable[Record], k: int, min_hits: int, device
) -> list[bytes]:
    """IDs of reads with >= min_hits matching windows (multiplicity
    counted, query.rs:87-103), in input order; reads shorter than k never
    match.  Raw read bytes: no normalization (query.rs:80-81).  The path
    for when the native parser is unavailable."""
    device = torch.device(device)
    records = list(records)
    hits = _records_hits(_db_on_device(db_vals, device), records, k, device)
    return _passing([r.id for r in records], [len(r.seq) for r in records], hits, k, min_hits)


class QueryBatch(NamedTuple):
    """One query batch as ``query_batches`` stages it."""

    lanes: torch.Tensor | None  # int32 wire lanes on the device; None: no positions, records only
    inv_words: torch.Tensor | None  # int32 invalid words on the device
    size: int  # wire positions, a multiple of 32
    n: int  # real positions
    starts: torch.Tensor | None  # int64 batch-local record starts, clamped at 0, on the device
    first_rid: int  # global index of the batch's first record
    records: list  # (id blob, id ends, lengths) of each chunk parsed since the previous batch


def query_batches(path, k: int, batch: int, device):
    """Parse (raw bytes, on the -t parser threads), cut
    (``host._rebatch_records``), wire-pack and stage the query batches of
    a file; run on the prefetch thread, so the host-to-device copies are
    enqueued before the consumer needs them, as ``staged_batches`` does
    for counting.  On CUDA a batch and its record starts are packed into a
    ``PinnedRing`` slot (the pack split over the parser threads) and
    copied without blocking; on the CPU the tensors are views of the
    packed arrays."""
    device = torch.device(device)
    threads = parse_threads()
    ring = PinnedRing(device, threads) if device.type == "cuda" else None
    chunks = native_chunks(path, k, normalize=False, threads=threads)
    if threads > 1:
        chunks = _prefetch(chunks, depth=2)  # the pieces checked and ordered on a thread of their own
    stream = ((p.codes, p.rec_ends, (p.id_blob, p.id_ends)) for p in chunks)
    try:
        for piece, starts, rids, new in _rebatch_records(stream, k, batch):
            records = [(blob, ends, lens) for (blob, ends), lens in new]
            if piece.shape[0] == 0:
                yield QueryBatch(None, None, 0, 0, None, 0, records)
            elif ring is None:
                lanes, inv_words, size, n, lo = _staged_plain(piece, starts, device)
                yield QueryBatch(lanes, inv_words, size, n, lo, int(rids[0]), records)
            else:
                n = piece.shape[0]
                size = -(-n // 32) * 32
                lanes, inv_words, lo = ring.stage(piece, size, np.maximum(starts, 0))
                yield QueryBatch(lanes, inv_words, size, n, lo, int(rids[0]), records)
    finally:
        if ring is not None:
            ring.close()


class _LateHits:
    """The per-read hit totals of a query, each batch's hits folded in
    one batch late: on CUDA they are copied into a pinned buffer behind an
    event when the batch is launched, and read once the next batch has
    been launched, so the device always has a batch queued and the host
    waits once a batch.  Two buffers: one being filled, one being read."""

    def __init__(self, device: torch.device):
        self.device = device
        self.hits = np.zeros(1024, dtype=np.int64)  # grown geometrically
        self._cuda = device.type == "cuda"
        self._bufs: list = [None, None]
        self._events = [torch.cuda.Event(), torch.cuda.Event()] if self._cuda else None
        self._next = 0
        self._pending = None  # (first rid, host hits, event) of the batch launched last

    def grow(self, n_records: int) -> None:
        if n_records > self.hits.shape[0]:
            more = np.zeros(max(self.hits.shape[0], n_records), dtype=np.int64)
            self.hits = np.concatenate([self.hits, more])

    def push(self, first_rid: int, batch_hits: torch.Tensor) -> None:
        """Start the fetch of one launched batch's hits, then fold the
        previous batch's."""
        event = None
        if self._cuda:
            i = self._next
            self._next ^= 1
            m = batch_hits.shape[0]
            if self._bufs[i] is None or self._bufs[i].shape[0] < m:
                self._bufs[i] = torch.empty(_bucket(m), dtype=torch.int64, pin_memory=True)
            host = self._bufs[i][:m]
            host.copy_(batch_hits, non_blocking=True)
            event = self._events[i]
            event.record(torch.cuda.current_stream(self.device))
            batch_hits = host
        self.flush()
        self._pending = (first_rid, batch_hits, event)

    def flush(self) -> None:
        """Fold the pending batch's hits in."""
        if self._pending is None:
            return
        first_rid, host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        # a batch's records are distinct and contiguous, so adding to the
        # slice folds a record split across cuts
        self.hits[first_rid : first_rid + host.shape[0]] += host.numpy()


def _query_stream(db_vals: np.ndarray, path, k: int, device):
    """(id blob, each id's end in it, lengths, window hits) of every read
    of a file, in input order: the batches of ``query_batches``, staged on
    the prefetch thread, launched here and their hits read one batch late
    (``_LateHits``).  Memory is O(chunk) beside the per-read arrays."""
    device = torch.device(device)
    db_keys = _db_on_device(db_vals, device)
    if not native.available():
        records = list(parse_fastx_file(path))
        ids = [r.id for r in records]
        id_ends = np.cumsum([len(i) for i in ids], dtype=np.int64)
        lens = np.array([len(r.seq) for r in records], dtype=np.int64)
        return b"".join(ids), id_ends, lens, _records_hits(db_keys, records, k, device)
    blobs, id_ends, lens = [], [], []
    n_records = blob_len = 0
    late = _LateHits(device)
    try:
        for qb in _prefetch(query_batches(path, k, batch_for(k, device), device)):
            for blob, ends, chunk_lens in qb.records:
                blobs.append(blob)
                id_ends.append(ends + blob_len)
                lens.append(chunk_lens)
                blob_len += len(blob)
                n_records += chunk_lens.shape[0]
            late.grow(n_records)
            if qb.n:
                late.push(qb.first_rid, _batch_hits(qb.lanes, qb.inv_words, qb.size, qb.n, qb.starts, db_keys, k))
        late.flush()
    except native.NativeParseError as e:
        raise FastxParseError(str(e)) from e
    except ContextError as e:
        raise FastxParseError(f"Failed to get input reader for file: {path}", e) from e
    empty = np.empty(0, np.int64)
    return (
        b"".join(blobs),
        np.concatenate(id_ends) if id_ends else empty,
        np.concatenate(lens) if lens else empty,
        late.hits[:n_records],
    )


def _lines_at(blob: bytes, id_ends: np.ndarray, keep: np.ndarray) -> bytes:
    """The ids of an id blob where ``keep`` holds, each followed by a
    newline, gathered in numpy: no Python object per read (a parsed id
    holds no newline)."""
    n = id_ends.shape[0]
    newline = id_ends + np.arange(n)  # each id's newline in the text of every id
    text = np.full(len(blob) + n, ord("\n"), dtype=np.uint8)
    is_id = np.ones(text.shape[0], dtype=bool)
    is_id[newline] = False
    text[is_id] = np.frombuffer(blob, np.uint8)
    return text[np.repeat(keep, np.diff(id_ends, prepend=0) + 1)].tobytes()


def query_hits(
    db_vals: np.ndarray, path, k: int, device
) -> tuple[list[bytes], list[int], np.ndarray]:
    """(ids, lengths, window hits) of every read of a file, in input
    order.  Streamed: uniform batches with a (k-1) halo at each cut, so
    every window is joined exactly once and memory is O(chunk)."""
    blob, id_ends, lens, hits = _query_stream(db_vals, path, k, device)
    ids = _lines_at(blob, id_ends, np.ones(id_ends.shape[0], dtype=bool)).split(b"\n")[:-1]
    return ids, lens.tolist(), hits


def query_lines(db_vals: np.ndarray, path, k: int, min_hits: int, device) -> bytes:
    """``query_file``'s ids as the query command writes them, each
    followed by a newline; only the passing reads' bytes are gathered."""
    blob, id_ends, lens, hits = _query_stream(db_vals, path, k, device)
    return _lines_at(blob, id_ends, (hits >= min_hits) & (lens >= k))


def query_file(db_vals: np.ndarray, path, k: int, min_hits: int, device) -> list[bytes]:
    """``query_records`` over a file, streamed (``_query_stream``)."""
    return query_lines(db_vals, path, k, min_hits, device).split(b"\n")[:-1]


class ClassifyJoiner:
    """Classify joins of reference sets against ONE input count table
    (classify.rs:224-236): the table goes to the device once, and each
    join() takes the concatenated k-mers of many references and answers
    membership both ways with one merge (``setops.classify_join``).

    Depth sums stay on the host and int64-exact: a matched reference
    k-mer IS an input k-mer, so its count is found by one searchsorted
    into the sorted input table."""

    # One join covers up to this many concatenated reference k-mers;
    # larger databases are chunked at reference boundaries.
    MAX_JOIN = 1 << 24

    def __init__(self, input_vals: np.ndarray, input_counts: np.ndarray, device):
        self.vals = input_vals
        self.counts = input_counts
        self._n = int(input_vals.shape[0])
        self._keys = _db_on_device(input_vals, torch.device(device))

    def join(self, ref_vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Member masks (over ref_vals, over the input table)."""
        nq = int(ref_vals.shape[0])
        if self._n == 0 or nq == 0:
            return np.zeros(nq, dtype=bool), np.zeros(self._n, dtype=bool)
        q = keys_from_u64(ref_vals).to(self._keys.device)
        member_q, member_db = setops.classify_join(q, self._keys)
        return member_q.cpu().numpy(), member_db.cpu().numpy()

    def depth_of(self, matched_vals: np.ndarray) -> int:
        """Summed input counts of matched k-mers, int64-exact
        (classify.rs:230-236 sum_depth)."""
        if matched_vals.shape[0] == 0:
            return 0
        idx = np.searchsorted(self.vals, matched_vals)
        return int(self.counts[idx].sum())


def intersection_size_host(a: np.ndarray, b: np.ndarray, device) -> int:
    """Exact |A intersect B| of two sorted unique u64 sets by one merge
    on ``device`` (compare.rs:58).  Either side may be empty."""
    device = torch.device(device)
    return int(setops.intersection_size(_db_on_device(a, device), _db_on_device(b, device)))
