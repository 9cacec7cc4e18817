"""Batched host -> device pipelines: counting (on one device, or over
several shards through ``parallel/``) and the set joins.

The torch counterpart of ``orion_kmer_tpu/engine.py``'s ``count_file``,
``unique_from_file``, ``query_file``/``query_records``,
``ClassifyJoiner`` and ``intersection_size_host``, plus ``query_hits``,
the per-read hit counts under ``query_file``, and ``query_lines``, its
ids as the query command writes them.  For counting, the host packs
FASTA/FASTQ records into wire-format batches on a prefetch thread and
stages them to the device (``staging.staged_batches``); the device
extracts and sorts each batch into a raw run of canonical keys,
accumulates runs in an LSM merge forest, run-length encodes once per
flush, and folds each flush into a device-resident count table
(``table.DeviceCountTable``, re-exported here); the host sees data only
when the table spills or at the end.  ``query_file`` streams its batches
the same way (``staging.query_batches``) and reads each batch's per-read
hits one batch late.

Everything runs on the ``device`` the caller passes: CUDA tensors go
through the kernels of ``csrc/``, CPU tensors through their plain torch
versions.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable

import numpy as np
import torch

from .errors import ContextError
from .host import _bucket, _prefetch, batch_for, iter_packed_batches, parse_spans, stream_file_codes
from .ingest import native
from .ingest.fastx import FastxParseError, Record, parse_fastx_file
from .keys import keys_from_u64
from .ops import setops
from .ops.extract import extract_keys
from .staging import PinnedRing, query_batches, stage_query, staged_batches
from .table import DeviceCountTable
from .utils import spans

logger = logging.getLogger("orion_kmer_tpu_torch.engine")


def make_count_table(k: int, device):
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
    one fetch.  Spread over several shards when ``make_count_table`` says
    so.  Returns (u64 values ascending, int64 counts).  Under an
    ``engine.count_file`` span."""
    with spans.span("engine.count_file"):
        device = torch.device(device)
        table = make_count_table(k, device)
        batch = batch_for(k, device)
        if isinstance(table, DeviceCountTable):
            batches = staged_batches(path, k, normalize, batch, device)

            def fold(staged) -> int:
                table.update_packed(*staged)
                return staged[3]

        else:
            # the sharded table cuts, packs and stages each batch itself
            batches = parse_spans(stream_file_codes(path, k, normalize, batch), k)

            def fold(codes) -> int:
                table.update(codes)
                return codes.shape[0]

        positions = 0
        t0 = time.monotonic()
        last_log = t0
        # engine.wait: the consumer, and the card, waiting on the host stage
        for item in spans.each(_prefetch(batches), "engine.wait"):
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


def _records_hits(db_keys, records: list[Record], k: int, device) -> np.ndarray:
    """Per-record window hits of parsed records (raw bytes, no
    normalization), in memory."""
    hits = np.zeros(len(records), dtype=np.int64)
    ring = PinnedRing(device)  # one part: no pool to close
    for pb in iter_packed_batches(
        records, k, normalize=False, batch_positions=batch_for(k, device), with_owner=True
    ):
        nr = len(pb.record_ids)
        starts = np.searchsorted(pb.owner, np.arange(nr))
        batch_hits = _batch_hits(*stage_query(ring, pb.codes, starts), db_keys, k)
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
            with spans.span("query.late_wait"):
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
        for qb in spans.each(_prefetch(query_batches(path, k, batch_for(k, device), device)), "engine.wait"):
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
    followed by a newline; only the passing reads' bytes are gathered,
    under a ``query.tail`` span."""
    blob, id_ends, lens, hits = _query_stream(db_vals, path, k, device)
    with spans.span("query.tail"):
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
