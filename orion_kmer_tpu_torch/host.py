"""Host side of the count pipeline: batching, wire packing, prefetch and
the host count accumulator.

These are copies of the JAX-free host functions of
``orion_kmer_tpu/engine.py`` (that module imports jax at load time, so
the port cannot import it).  ``tests/test_torch_host.py`` pins every
copy byte-equal to its original.

Records are packed into batches of 2-bit codes separated by k-1 invalid
positions, so no window spans two records; long records are split with
a (k-1)-base halo, so every window is produced exactly once.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, NamedTuple

import numpy as np

from . import codec
from .errors import ContextError
from .ingest import native
from .ingest.compress import open_input
from .ingest.fastx import FastxParseError, Record, parse_fastx_file
from .utils.progress import worker_threads

_MIN_BUCKET = 4096


def default_batch(device=None) -> int:
    """Positions per device batch: ``ORION_KMER_BATCH`` when set, else
    2^24 on CUDA and 2^22 elsewhere (the CPU path serves tests)."""
    env = int(os.environ.get("ORION_KMER_BATCH", 0))
    if env:
        return env
    is_cuda = device is not None and getattr(device, "type", device) == "cuda"
    return (1 << 24) if is_cuda else (1 << 22)


def _bucket(n: int, minimum: int = _MIN_BUCKET) -> int:
    return max(minimum, 1 << max(n - 1, 1).bit_length())


def _pad(arr: np.ndarray, size: int, fill) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def pack_for_transfer(codes: np.ndarray, size: int):
    """Host-side wire packing: codes u8[n] (255 = invalid) padded to
    ``size`` (multiple of 32) -> (lanes u32[size/16], invalid u32[size/32]).

    Base j of lane w sits at bits 2j..2j+1 of lanes[w]; invalid flags are
    1 bit per base, little-endian within each u32 word.  Uses the native
    C packer when available."""
    if size % 32:
        raise ValueError(f"wire size must be a multiple of 32, got {size}")
    if native.available():
        return native.pack_wire(codes, size)
    codes_p = _pad(codes, size, codec.INVALID_CODE)
    invalid = codes_p > 3
    c = np.where(invalid, 0, codes_p).astype(np.uint32).reshape(-1, 16)
    lanes = np.zeros(size // 16, dtype=np.uint32)
    for j in range(16):
        lanes |= c[:, j] << np.uint32(2 * j)
    inv_words = np.packbits(invalid, bitorder="little").view(np.uint32)
    return lanes, inv_words


class PackedBatch(NamedTuple):
    codes: np.ndarray  # uint8 [n]
    invalid: np.ndarray  # bool [n]
    owner: np.ndarray | None  # int32 [n]: local record index per position
    first_rid: int  # global index of local record 0
    record_ids: list[bytes] | None  # ids of records present in this batch


def iter_packed_batches(
    records: Iterable[Record],
    k: int,
    normalize: bool = True,
    batch_positions: int = 0,
    with_owner: bool = False,
) -> Iterator[PackedBatch]:
    """Pack records into batches of 2-bit codes with separators/halos.

    A record longer than the remaining batch space is split with a
    (k-1)-position halo; it then appears in multiple batches under the
    same global record index (= first_rid + local owner), and callers
    must sum per-record statistics across batches.
    """
    batch_positions = batch_positions or default_batch()
    sep = k - 1
    sep_arr = np.full(sep, codec.INVALID_CODE, dtype=np.uint8)

    parts: list[np.ndarray] = []
    owners: list[np.ndarray] = []
    batch_ids: list[bytes] = []
    batch_first_rid = 0
    used = 0
    global_rid = -1

    def make_batch() -> PackedBatch:
        codes = np.concatenate(parts) if len(parts) > 1 else parts[0]
        owner = None
        if with_owner:
            owner = np.concatenate(owners) if len(owners) > 1 else owners[0]
        return PackedBatch(
            codes=codes,
            invalid=codes == codec.INVALID_CODE,
            owner=owner,
            first_rid=batch_first_rid,
            record_ids=list(batch_ids) if with_owner else None,
        )

    for rec in records:
        global_rid += 1
        if with_owner:
            batch_ids.append(rec.id)
        rcodes = codec.seq_to_codes(rec.seq, normalize=normalize)
        pos = 0
        while True:
            if used >= batch_positions:
                yield make_batch()
                parts, owners, used = [], [], 0
                batch_first_rid = global_rid
                batch_ids = [rec.id] if with_owner else []
            room = batch_positions - used
            take = min(len(rcodes) - pos, max(room, k))
            piece = rcodes[pos : pos + take]
            parts.append(piece)
            if with_owner:
                owners.append(
                    np.full(len(piece), global_rid - batch_first_rid, dtype=np.int32)
                )
            used += len(piece)
            if pos + take >= len(rcodes):
                break
            pos = pos + take - (k - 1)  # halo: boundary windows produced once
        # separator so no window spans into the next record
        parts.append(sep_arr)
        if with_owner:
            owners.append(np.full(sep, global_rid - batch_first_rid, dtype=np.int32))
        used += sep

    if parts:
        yield make_batch()


def _iter_batches_from_packed(
    codes: np.ndarray,
    rec_ends: np.ndarray,
    ids: list[bytes],
    k: int,
    batch_positions: int,
    with_owner: bool,
    rid_offset: int = 0,
) -> Iterator[PackedBatch]:
    """Batch a natively-packed code stream with (k-1) halos at splits.

    ``rid_offset`` shifts first_rid so record indices stay globally
    unique when the stream arrives as multiple chunks."""
    n = codes.shape[0]
    invalid = codes == codec.INVALID_CODE
    owner_full = None
    if with_owner:
        sep = k - 1
        ends_incl = rec_ends + sep  # each record region includes its separator
        lengths = np.diff(np.concatenate([[0], ends_incl]))
        owner_full = np.repeat(
            np.arange(len(ids), dtype=np.int32), lengths.astype(np.int64)
        )
    a = 0
    while True:
        b = min(a + batch_positions, n)
        sl_codes = codes[a:b]
        owner = None
        first_rid = 0
        rec_ids = None
        if with_owner:
            first_rid = int(owner_full[a]) if n else 0
            last_rid = int(owner_full[b - 1]) if n else -1
            owner = owner_full[a:b] - np.int32(first_rid)
            rec_ids = ids[first_rid : last_rid + 1]
            first_rid += rid_offset
        yield PackedBatch(
            codes=sl_codes,
            invalid=invalid[a:b],
            owner=owner,
            first_rid=first_rid,
            record_ids=rec_ids,
        )
        if b >= n:
            break
        a = b - (k - 1)  # halo: boundary windows produced exactly once


# Decompressed bytes pulled per streaming-ingest chunk.  Memory per open
# stream is O(chunk + largest record), never O(file).
CHUNK_BYTES = int(os.environ.get("ORION_KMER_CHUNK_BYTES", str(64 << 20)))


def stream_native_chunks(
    path, k: int, normalize: bool = True, chunk_bytes: int | None = None
) -> Iterator[tuple[np.ndarray, np.ndarray, list[bytes]]]:
    """Chunked-decompression -> incremental native parse: yields
    (codes, rec_ends, ids) tuples of WHOLE records; a record spanning a
    chunk boundary is carried over (so one yield can exceed chunk_bytes
    only by the unfinished record's length)."""
    if chunk_bytes is None:
        chunk_bytes = CHUNK_BYTES
    src = str(path)
    seen = False
    carry = b""
    with open_input(path) as f:
        while True:
            try:
                data = f.read(chunk_bytes)
            except OSError as e:
                raise ContextError(f"Failed to read input file: {src!r}", e) from e
            eof = not data
            buf = carry + data if carry else data
            if eof and not buf:
                if seen:
                    return
                raise native.NativeParseError(native.OKT_EMPTY, src)
            try:
                codes, rec_ends, ids, consumed = native.parse_fastx_chunk(
                    buf, k, normalize=normalize, eof=eof, source=src
                )
            except native.NativeParseError as e:
                if eof and seen and e.code == native.OKT_EMPTY:
                    return  # trailing whitespace after real records
                raise
            if ids:
                seen = True
                yield codes, rec_ends, ids
            if eof:
                return
            carry = buf[consumed:]


def _rebatch_codes(chunks, k: int, batch_positions: int) -> Iterator[PackedBatch]:
    """Re-batch a (codes, rec_ends, ids) chunk stream into UNIFORM
    batch_positions-sized batches, carrying the remainder across chunk
    boundaries (with the usual (k-1) halo at every split), so every
    batch but the file's last has the same size."""
    buf: list[np.ndarray] = []
    total = 0
    for codes, _rec_ends, _ids in chunks:
        buf.append(codes)
        total += codes.shape[0]
        while total >= batch_positions:
            cat = np.concatenate(buf) if len(buf) > 1 else buf[0]
            piece = cat[:batch_positions]
            yield PackedBatch(
                codes=piece,
                invalid=piece == codec.INVALID_CODE,
                owner=None,
                first_rid=0,
                record_ids=None,
            )
            rest = cat[batch_positions - (k - 1) :]  # halo at the split
            buf = [rest]
            total = rest.shape[0]
    if total:
        cat = np.concatenate(buf) if len(buf) > 1 else buf[0]
        yield PackedBatch(
            codes=cat,
            invalid=cat == codec.INVALID_CODE,
            owner=None,
            first_rid=0,
            record_ids=None,
        )


def stream_file_batches(
    path,
    k: int,
    normalize: bool = True,
    batch_positions: int = 0,
    with_owner: bool = False,
) -> Iterator[PackedBatch]:
    """File -> PackedBatch stream via the native C++ tokenizer when
    available (one pass, zero Python per record, O(chunk) memory), else
    the line-streaming Python parser (O(record) memory)."""
    batch_positions = batch_positions or default_batch()
    native_err = native.NativeParseError  # bind before the generator loop
    if native.available():
        try:
            chunks = stream_native_chunks(path, k, normalize)
            if not with_owner:
                # uniform batch sizes across chunk boundaries (see
                # _rebatch_codes) -- counting is record-agnostic
                yield from _rebatch_codes(chunks, k, batch_positions)
                return
            rid_offset = 0
            for codes, rec_ends, ids in chunks:
                yield from _iter_batches_from_packed(
                    codes, rec_ends, ids, k, batch_positions, with_owner, rid_offset
                )
                rid_offset += len(ids)
        except native_err as e:
            raise FastxParseError(str(e)) from e
        except ContextError as e:
            raise FastxParseError(
                f"Failed to get input reader for file: {path}", e
            ) from e
    else:
        yield from iter_packed_batches(
            parse_fastx_file(path),
            k,
            normalize=normalize,
            batch_positions=batch_positions,
            with_owner=with_owner,
        )


def _merge_sorted_unique_runs(v1, c1, v2, c2):
    """Merge two sorted-unique (vals, counts) runs, summing counts of
    values present in both.

    Native two-pointer pass when available; otherwise a searchsorted
    interleave (no argsort over the concatenation: the runs are already
    sorted)."""
    n1, n2 = v1.shape[0], v2.shape[0]
    if n1 == 0:
        return v2, c2
    if n2 == 0:
        return v1, c1
    if native.available():
        return native.merge_unique(v1, c1, v2, c2)
    out_v = np.empty(n1 + n2, dtype=v1.dtype)
    out_c = np.empty(n1 + n2, dtype=np.int64)
    i1 = np.searchsorted(v2, v1, side="left") + np.arange(n1)
    i2 = np.searchsorted(v1, v2, side="right") + np.arange(n2)
    out_v[i1] = v1
    out_v[i2] = v2
    out_c[i1] = c1
    out_c[i2] = c2
    head = np.empty(n1 + n2, dtype=bool)
    head[0] = True
    np.not_equal(out_v[1:], out_v[:-1], out=head[1:])
    idx = np.flatnonzero(head)
    if idx.shape[0] == n1 + n2:  # disjoint values: nothing to collapse
        return out_v, out_c
    return out_v[idx], np.add.reduceat(out_c, idx)


class CountAccumulator:
    """Merge per-spill sorted-unique (vals u64, counts i64) runs on the
    host.

    result() reduces the runs smallest-pair-first with sorted merges, and
    merged inputs are released immediately, so peak extra memory is ~the
    final output + the two inputs of the current merge."""

    # consolidate when held entries exceed max(2x last consolidated
    # size, this floor): without it, a high-coverage input re-lists its
    # genome k-mers in every spill and host memory grows with spills,
    # not with the table.  Amortized O(n log spills), same shape as the LSM.
    CONSOLIDATE_FLOOR = 1 << 25

    def __init__(self):
        self._vals: list[np.ndarray] = []
        self._counts: list[np.ndarray] = []
        self._total = 0
        self._threshold = self.CONSOLIDATE_FLOOR

    def add(self, vals: np.ndarray, counts: np.ndarray) -> None:
        if vals.shape[0]:
            self._vals.append(vals)
            self._counts.append(counts.astype(np.int64))
            self._total += vals.shape[0]
            if self._total > self._threshold:
                self._consolidate()

    def _merge_all(self) -> tuple[np.ndarray, np.ndarray]:
        if 1 < len(self._vals) <= native.MAX_KWAY and native.available():
            # one native pass, one output allocation
            return native.merge_unique_kway(self._vals, self._counts)
        runs = list(zip(self._vals, self._counts))
        while len(runs) > 1:
            runs.sort(key=lambda vc: vc[0].shape[0], reverse=True)
            v2, c2 = runs.pop()
            v1, c1 = runs.pop()
            runs.append(_merge_sorted_unique_runs(v1, c1, v2, c2))
        return runs[0]

    def _consolidate(self) -> None:
        v, c = self._merge_all()
        self._vals, self._counts = [v], [c]
        self._total = v.shape[0]
        self._threshold = max(2 * self._total, self.CONSOLIDATE_FLOOR)

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._vals:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        return self._merge_all()


def _prefetch(iterator, depth: int | None = None):
    """Run an iterator on a background thread with a bounded queue so host
    parse/pack overlaps device compute.  Queue depth follows -t/--threads
    (ORION_KMER_THREADS; min 2)."""
    import queue
    import threading

    if depth is None:
        depth = max(2, worker_threads(default=2))
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
    t.join()
    if err:
        raise err[0]
