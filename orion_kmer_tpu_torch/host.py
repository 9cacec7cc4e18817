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

import contextvars
import io
import os
import queue
import threading
from typing import Iterable, Iterator, NamedTuple

import numpy as np

from . import codec
from .errors import ContextError
from .ingest import native
from .ingest.compress import open_input
from .ingest.fastx import FastxParseError, Record, parse_fastx_file
from .utils import spans
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


def batch_for(k: int, device=None, batch_positions: int | None = None) -> int:
    """Positions per batch of a k-mer stream: ``batch_positions`` when
    given, else ``default_batch(device)``, and never fewer than k, so
    every batch holds a window and every cut advances (by one position at
    a batch of k, as ``iter_packed_batches`` does).  Every batching path
    takes its size from here."""
    return max(batch_positions or default_batch(device), k)


def _bucket(n: int, minimum: int = _MIN_BUCKET) -> int:
    return max(minimum, 1 << max(n - 1, 1).bit_length())


def wire_size(n: int) -> int:
    """``n`` positions rounded up to whole invalid words (32 positions a
    word): the wire size of a query batch and of a shard's block."""
    return -(-n // 32) * 32


def _pad(arr: np.ndarray, size: int, fill) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def pack_for_transfer(codes: np.ndarray, size: int, out=None):
    """Host-side wire packing: codes u8[n] (255 = invalid) padded to
    ``size`` (multiple of 32) -> (lanes u32[size/16], invalid u32[size/32]).

    Base j of lane w sits at bits 2j..2j+1 of lanes[w]; invalid flags are
    1 bit per base, little-endian within each u32 word.  Uses the native
    C packer when available.  ``out``: a (lanes, invalid) pair of u32
    arrays of those lengths to write into instead of new arrays."""
    if size % 32:
        raise ValueError(f"wire size must be a multiple of 32, got {size}")
    if native.available():
        return native.pack_wire(codes, size, out=out)
    codes_p = _pad(codes, size, codec.INVALID_CODE)
    invalid = codes_p > 3
    c = np.where(invalid, 0, codes_p).astype(np.uint32).reshape(-1, 16)
    lanes = np.zeros(size // 16, dtype=np.uint32)
    for j in range(16):
        lanes |= c[:, j] << np.uint32(2 * j)
    inv_words = np.packbits(invalid, bitorder="little").view(np.uint32)
    if out is None:
        return lanes, inv_words
    out[0][:] = lanes
    out[1][:] = inv_words
    return out


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
    batch_positions = batch_for(k, None, batch_positions)
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

# Most parser threads a stream uses, whatever -t asks for: each holds a
# piece of CHUNK_BYTES, so -t 0 on a large host must not mean one each
# for hundreds of cores.  On the 8-core host of an NVIDIA H100 the parse
# of 0.5 Gbp of reads is no faster on more than four threads (each call
# slows as threads are added) and `count` no faster on more than two
# (tools/torch_ingest_rate.py; PERF.md, "Host ingest").
MAX_PARSE_THREADS = 4


def parse_threads() -> int:
    """Parser threads of a streaming parse: -t/--threads (the CLI exports
    it as ORION_KMER_THREADS; 0 and library callers without it = all
    logical cores), at most MAX_PARSE_THREADS."""
    return max(1, min(worker_threads(), MAX_PARSE_THREADS))


def piece_bound(threads: int) -> int:
    """Most pieces of a parallel parse alive at once: the queue of parsed
    or parsing pieces (``threads``), the one the reader waits to queue, the
    verifier's current and previous piece, and the serial chunk it
    rebuilds after a wrong guess.  Each holds at most chunk_bytes plus the
    longest record, and its parse output about as much again."""
    return threads + 4


class ParseStats:
    """What a parallel parse did, for the caller that passes one: the
    pieces alive at once (now and at the peak; ``piece_bound`` bounds
    them) and the guesses of a cut that were wrong."""

    def __init__(self):
        self._lock = threading.Lock()
        self.live = self.peak = self.misses = 0

    def add(self, n: int) -> None:
        with self._lock:
            self.live += n
            self.peak = max(self.peak, self.live)


_WHITESPACE = b" \t\r\n"
_SCAN_WINDOW = 1 << 16


def _first_non_ws(buf) -> int:
    """Offset of the first byte of ``buf`` that is not whitespace (the
    parser's format marker), or len(buf)."""
    n = len(buf)
    lo, w = 0, _SCAN_WINDOW
    while lo < n:
        part = bytes(buf[lo : lo + w])
        rest = part.lstrip(_WHITESPACE)
        if rest:
            return lo + len(part) - len(rest)
        lo += w
        w *= 8
    return n


def _fastq_walk(t: bytes, pos: int) -> int:
    """From a record start in ``t``, where the FASTQ parse with eof=0 stops:
    the start of the first record with a line not ended by a newline, or
    len(t).  Blank lines between records are skipped, as the parser does."""
    n = len(t)
    while pos < n:
        rec = pos
        nl = t.find(b"\n", pos)
        if nl < 0:
            return n if t[pos:] in (b"", b"\r") else rec
        end = nl - 1 if nl > pos and t[nl - 1] == 13 else nl
        if end == pos:  # blank line
            pos = nl + 1
            continue
        x = nl
        for _ in range(3):  # sequence, '+' and quality lines
            x = t.find(b"\n", x + 1)
            if x < 0:
                return rec
        pos = x + 1
    return n


def _fastq_anchor(t: bytes) -> int:
    """The last line of ``t`` that starts with '@' and whose second-next
    line starts with '+': a record start (a quality line may start with
    '@', but the line two after it is a sequence line).  -1 if none."""
    hi = len(t)
    while True:
        p = t.rfind(b"\n@", 0, hi)
        if p < 0:
            return -1
        e0 = t.find(b"\n", p + 1)
        e1 = t.find(b"\n", e0 + 1) if e0 >= 0 else -1
        if 0 <= e1 < len(t) - 1 and t[e1 + 1] == 43:  # '+'
            return p + 1
        hi = p


def guess_cut(buf, fmt: int) -> int:
    """Where the parse of ``buf`` with eof=0 will stop (its ``consumed``),
    from the bytes near its end alone: FASTA ('>'), the start of the last
    header line; FASTQ ('@'), the start of the first record that is not
    complete after the last certain record start.  A guess: the parallel
    parse checks it against the parse and re-parses where it was wrong."""
    n = len(buf)
    w = _SCAN_WINDOW
    while True:
        lo = max(0, n - w)
        t = bytes(buf[lo:])
        if fmt == ord(">"):
            p = t.rfind(b"\n>")
            if p >= 0:
                return lo + p + 1
        else:
            a = _fastq_anchor(t)
            if a >= 0:
                return lo + _fastq_walk(t, a)
        if lo == 0:
            break
        w *= 8
    q = _first_non_ws(buf)
    if fmt == ord(">") or q == n:
        return q
    return q + _fastq_walk(bytes(buf[q:]), 0)


def _join(tail, data) -> np.ndarray | bytes:
    """tail + data (any buffers) as one buffer, copied by numpy outside
    the GIL; ``data`` itself, as bytes or an array, when there is no
    tail."""
    if len(tail) == 0:
        return data if isinstance(data, (bytes, np.ndarray)) else np.frombuffer(data, np.uint8)
    out = np.empty(len(tail) + len(data), np.uint8)
    out[: len(tail)] = np.frombuffer(tail, np.uint8)
    out[len(tail) :] = np.frombuffer(data, np.uint8)
    return out


def _serial_chunks(f, src, k, normalize, chunk_bytes):
    """The serial parse: each chunk read, joined to the carry and parsed
    in turn on the calling thread."""
    seen = False
    carry = b""
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
            parsed = native.parse_fastx_raw(buf, k, normalize=normalize, eof=eof, source=src)
        except native.NativeParseError as e:
            if eof and seen and e.code == native.OKT_EMPTY:
                return  # trailing whitespace after real records
            raise
        if parsed.rec_ends.shape[0]:
            seen = True
            yield parsed
        if eof:
            return
        carry = buf[parsed.consumed :]


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put ``item`` unless ``stop`` is set first."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


class _Buffers:
    """The pieces' byte buffers, each taken again once its piece is
    retired, so a chunk is read into memory that is already mapped."""

    def __init__(self, keep: int):
        self._keep = keep
        self._free: list[np.ndarray] = []
        self._lock = threading.Lock()

    def take(self, n: int) -> np.ndarray:
        with self._lock:
            for i, b in enumerate(self._free):
                if b.shape[0] >= n:
                    return self._free.pop(i)
        return np.empty(n + (1 << 20), np.uint8)  # room for a carry to grow

    def give(self, buf: np.ndarray | None) -> None:
        if buf is not None:
            with self._lock:
                if len(self._free) < self._keep:
                    self._free.append(buf)


def _read_ahead(f, src, chunk_bytes, parse, pool, buffers, jobs, stop, stats) -> None:
    """Reader stage of the parallel parse: read each chunk into a buffer
    after the guessed carry, submit its parse and queue (start, buffer,
    eof, future, the buffer's base) in stream order; a read error is
    queued in its place.  A plain file is read straight into the buffer
    (``readinto`` fills it as ``read`` of the same size would)."""
    direct = isinstance(f, io.BufferedReader)
    start = 0  # stream offset of the next piece's first byte
    prev, prev_start = b"", 0
    fmt = None  # the format marker, from the first byte that is not whitespace
    try:
        while not stop.is_set():
            tail = memoryview(prev)[start - prev_start :]
            t = len(tail)
            base = buffers.take(t + chunk_bytes)
            if t:
                base[:t] = np.frombuffer(tail, np.uint8)
            try:
                if direct:
                    n = f.readinto(memoryview(base)[t : t + chunk_bytes])
                else:
                    data = f.read(chunk_bytes)
                    n = len(data)
                    base[t : t + n] = np.frombuffer(data, np.uint8)
            except OSError as e:
                _put(jobs, ContextError(f"Failed to read input file: {src!r}", e), stop)
                return
            eof = n == 0
            buf = base[: t + n]
            stats.add(1)
            if not _put(jobs, (start, buf, eof, pool.submit(parse, buf, eof), base), stop) or eof:
                return
            if fmt is None:
                q = _first_non_ws(buf)
                fmt = int(buf[q]) if q < len(buf) else None
            cut = len(buf) if fmt is None else guess_cut(buf, fmt)
            prev, prev_start, start = buf, start, start + cut
    except BaseException as e:  # noqa: BLE001 - raised by the verifier in order
        _put(jobs, e, stop)


def _parallel_chunks(f, src, k, normalize, chunk_bytes, threads, stats):
    """The parse spread over ``threads`` parser threads, yielding exactly
    the serial parse's chunks.

    The reader guesses where each chunk's carry starts (``guess_cut``) and
    parses the pieces ahead on a pool.  Here, in stream order, each piece
    is checked against the true cut (the previous piece's start plus its
    ``consumed``): when the guess holds, the piece is the serial chunk
    byte for byte (by induction from offset 0); when not, the serial chunk
    is rebuilt from the previous piece and parsed on this thread.  A
    parse error counts only once every earlier piece has checked, so the
    first error in stream order is raised, with the serial message."""
    from concurrent.futures import ThreadPoolExecutor

    def parse(buf, eof):
        return native.parse_fastx_raw(buf, k, normalize=normalize, eof=eof, source=src)

    pool = ThreadPoolExecutor(threads, thread_name_prefix="okt-parse")
    buffers = _Buffers(keep=piece_bound(threads))
    jobs: "queue.Queue" = queue.Queue(maxsize=threads)
    stop = threading.Event()
    reader = threading.Thread(
        target=_read_ahead, args=(f, src, chunk_bytes, parse, pool, buffers, jobs, stop, stats),
        name="okt-read", daemon=True,
    )
    reader.start()
    cut, seen = 0, False
    prev, prev_start, have_prev = b"", 0, False  # the previous piece as parsed
    prev_base = None  # its buffer, given back once the piece after it is done
    try:
        while True:
            item = jobs.get()
            if isinstance(item, BaseException):
                raise item
            start, buf, eof, fut, base = item
            if start != cut:  # a wrong guess: rebuild the serial chunk
                fut.cancel()  # its buffer is not given back: the parse may still read it
                fut, base = None, None
                stats.misses += 1
                read_at = prev_start + len(prev)  # where this piece's chunk begins
                buf = _join(memoryview(prev)[cut - prev_start :], memoryview(buf)[read_at - start :])
                stats.add(1)  # the rebuilt piece, while the guessed one is still held
                stats.add(-1)
                start = cut
            if eof and not len(buf):
                if seen:
                    return
                raise native.NativeParseError(native.OKT_EMPTY, src)
            try:
                parsed = parse(buf, eof) if fut is None else fut.result()
            except native.NativeParseError as e:
                if eof and seen and e.code == native.OKT_EMPTY:
                    return  # trailing whitespace after real records
                raise
            if parsed.rec_ends.shape[0]:
                seen = True
                yield parsed
            if eof:
                return
            cut = start + parsed.consumed
            if have_prev:
                stats.add(-1)
                buffers.give(prev_base)
            prev, prev_start, prev_base, have_prev = buf, start, base, True
    finally:
        stop.set()
        while reader.is_alive():
            try:
                jobs.get(timeout=0.05)
            except queue.Empty:
                pass
        pool.shutdown(wait=True, cancel_futures=True)


def native_chunks(
    path,
    k: int,
    normalize: bool = True,
    chunk_bytes: int | None = None,
    threads: int | None = None,
    stats: ParseStats | None = None,
) -> Iterator[native.ParsedChunk]:
    """The chunks of ``stream_native_chunks`` as ``native.ParsedChunk``s,
    whose ids stay one blob: for the callers that use no ids.  ``stats``,
    where given, records a parallel parse."""
    if chunk_bytes is None:
        chunk_bytes = CHUNK_BYTES
    if threads is None:
        threads = parse_threads()
    src = str(path)
    with open_input(path) as f:
        if threads <= 1:
            yield from _serial_chunks(f, src, k, normalize, chunk_bytes)
        else:
            stats = stats if stats is not None else ParseStats()
            yield from _parallel_chunks(f, src, k, normalize, chunk_bytes, threads, stats)


def stream_native_chunks(
    path,
    k: int,
    normalize: bool = True,
    chunk_bytes: int | None = None,
    threads: int | None = None,
    stats: ParseStats | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray, list[bytes]]]:
    """Chunked-decompression -> incremental native parse: yields
    (codes, rec_ends, ids) tuples of WHOLE records; a record spanning a
    chunk boundary is carried over (so one yield can exceed chunk_bytes
    only by the unfinished record's length).

    The parse runs on ``threads`` parser threads (default
    ``parse_threads()``, from -t) and yields the same chunks, in the same
    order, as the serial parse (``threads=1``) for any thread count and
    chunk size."""
    for p in native_chunks(path, k, normalize, chunk_bytes, threads, stats):
        yield p.codes, p.rec_ends, p.ids()


def _rebatch_arrays(code_arrays, k: int, batch_positions: int) -> Iterator[np.ndarray]:
    """Cut a stream of code arrays into UNIFORM batch_positions-sized
    batches with the usual (k-1) halo at every cut, so every batch but the
    stream's last has the same size.  A batch inside one array is a view
    of it: only a batch that spans two arrays is copied."""
    if batch_positions < k:
        raise ValueError(f"a batch of {batch_positions} positions holds no {k}-mer window")
    held: list[np.ndarray] = []  # the codes not yet cut, in order
    total = 0
    step = batch_positions - (k - 1)  # halo: boundary windows produced once
    for codes in code_arrays:
        held.append(codes)
        total += codes.shape[0]
        while total >= batch_positions:
            if held[0].shape[0] >= batch_positions:
                yield held[0][:batch_positions]
            else:
                parts, need = [], batch_positions
                for a in held:
                    parts.append(a[:need])
                    need -= parts[-1].shape[0]
                    if not need:
                        break
                yield np.concatenate(parts)
            drop = step
            while drop:
                if held[0].shape[0] <= drop:
                    drop -= held.pop(0).shape[0]
                else:
                    held[0] = held[0][drop:]
                    drop = 0
            total -= step
    if total:
        yield np.concatenate(held) if len(held) > 1 else held[0]


def _rebatch_records(chunks, k: int, batch_positions: int):
    """Cut a (codes, rec_ends, ids) stream of whole records, as
    ``stream_native_chunks`` yields it, into the UNIFORM batches of
    ``_rebatch_arrays`` (a (k-1) halo at every cut), keeping the records
    of each batch.

    Yields (piece, starts, rids, new) per batch: the batch's codes, a view
    where they lie inside one chunk and a copy only where they span
    chunks; the batch-local start of every record with positions in it (a
    record's region runs to the next start, its separator included; the
    first start is negative when the record began in an earlier batch);
    those records' global indices, ascending and contiguous; and, for each
    chunk received since the previous yield, (ids, lengths) of its
    records, the ids passed on as the chunk gave them.  Where the stream
    leaves records whose ids were not yet yielded but no positions after
    the last cut, it ends with an empty piece that carries them."""
    if batch_positions < k:
        raise ValueError(f"a batch of {batch_positions} positions holds no {k}-mer window")
    sep = k - 1
    step = batch_positions - sep
    held: list[tuple] = []  # (codes, offset, starts, region ends, first rid) of the chunks not yet cut past
    new: list[tuple] = []
    start = total = n_records = 0  # stream offsets of the next batch and of the end; records so far

    def cut(end: int, last: bool):
        parts, starts, rids = [], [], []
        for codes, off, st, en, rid0 in held:
            if off >= end and not last:
                break
            part = codes[max(start - off, 0) : end - off]
            if part.shape[0]:
                parts.append(part)
            # the records whose regions reach past the cut and begin before
            # the batch's end (at the stream's end: every one left)
            r0 = int(np.searchsorted(en, start - off, side="right"))
            r1 = st.shape[0] if last else int(np.searchsorted(st, end - off, side="left"))
            starts.append(st[r0:r1] + (off - start))
            rids.append(np.arange(rid0 + r0, rid0 + r1, dtype=np.int64))
        piece = parts[0] if len(parts) == 1 else np.concatenate(parts) if parts else np.empty(0, np.uint8)
        return piece, np.concatenate(starts), np.concatenate(rids)

    for codes, rec_ends, ids in chunks:
        st = np.empty(rec_ends.shape[0], np.int64)
        st[:1] = 0
        st[1:] = rec_ends[:-1] + sep
        held.append((codes, total, st, rec_ends + sep, n_records))
        new.append((ids, rec_ends - st))
        total += codes.shape[0]
        n_records += rec_ends.shape[0]
        while total - start >= batch_positions:
            yield (*cut(start + batch_positions, False), new)
            new = []
            start += step
            while held and held[0][1] + held[0][0].shape[0] <= start:
                held.pop(0)  # every record of it ends before the next batch
    if total > start:
        yield (*cut(total, True), new)
    elif new:
        empty = np.empty(0, np.int64)
        yield np.empty(0, np.uint8), empty, empty, new


def _rebatch_codes(chunks, k: int, batch_positions: int) -> Iterator[PackedBatch]:
    """Re-batch a (codes, rec_ends, ids) chunk stream into UNIFORM
    batch_positions-sized batches, carrying the remainder across chunk
    boundaries (with the usual (k-1) halo at every split), so every
    batch but the file's last has the same size."""
    for piece in _rebatch_arrays((c[0] for c in chunks), k, batch_positions):
        yield PackedBatch(
            codes=piece,
            invalid=piece == codec.INVALID_CODE,
            owner=None,
            first_rid=0,
            record_ids=None,
        )


def stream_file_codes(path, k: int, normalize: bool = True, batch_positions: int = 0) -> Iterator[np.ndarray]:
    """The codes of ``stream_file_batches(..., with_owner=False)``, batch by
    batch, without the masks nobody on the count path reads.  With the
    native parser the parse runs on ``parse_threads()`` threads, and the
    checking and ordering of their pieces on a thread of its own, ahead of
    the re-batching."""
    batch_positions = batch_for(k, None, batch_positions)
    if not native.available():
        for pb in stream_file_batches(path, k, normalize, batch_positions):
            yield pb.codes
        return
    native_err = native.NativeParseError  # bind before the generator loop
    try:
        threads = parse_threads()
        chunks = native_chunks(path, k, normalize, threads=threads)
        if threads > 1:
            chunks = _prefetch(chunks, depth=2)
        yield from _rebatch_arrays((p.codes for p in chunks), k, batch_positions)
    except native_err as e:
        raise FastxParseError(str(e)) from e
    except ContextError as e:
        raise FastxParseError(f"Failed to get input reader for file: {path}", e) from e


def parse_spans(batches, k: int, positions=len):
    """``batches`` of a k-mer stream as ``_rebatch_arrays`` or
    ``_rebatch_records`` cut it, each ``next()`` under an ``ingest.parse``
    span that counts the positions new in its batch (each batch after the
    first repeats the (k-1)-position halo of the one before), so the
    counts sum to the stream's positions.  ``positions`` gives a batch's
    positions."""
    halo = 0

    def counted(batch, sp) -> None:
        nonlocal halo
        sp.add("positions", max(0, positions(batch) - halo))
        halo = k - 1

    return spans.each(batches, "ingest.parse", counted)


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
    batch_positions = batch_for(k, None, batch_positions)
    if native.available() and not with_owner:
        # uniform batch sizes across chunk boundaries (see _rebatch_arrays)
        # -- counting is record-agnostic
        for piece in stream_file_codes(path, k, normalize, batch_positions):
            yield PackedBatch(
                codes=piece,
                invalid=piece == codec.INVALID_CODE,
                owner=None,
                first_rid=0,
                record_ids=None,
            )
        return
    native_err = native.NativeParseError  # bind before the generator loop
    if native.available():
        try:
            rid_offset = 0
            for p in native_chunks(path, k, normalize):
                ids = p.ids()
                yield from _iter_batches_from_packed(
                    p.codes, p.rec_ends, ids, k, batch_positions, with_owner, rid_offset
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
            self._counts.append(counts.astype(np.int64, copy=False))
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
    (ORION_KMER_THREADS; min 2).  A consumer that stops early stops the
    thread, which closes the iterator.  The thread runs under a copy of
    the caller's context at this call, so its spans (``utils/spans.py``)
    have the caller's open span as their parent."""
    if depth is None:
        depth = max(2, worker_threads(default=2))
    return _prefetched(iterator, depth, contextvars.copy_context())


def _prefetched(iterator, depth: int, context: contextvars.Context):
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                if not _put(q, item, stop):
                    break
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            err.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            _put(q, _END, stop)

    t = threading.Thread(target=context.run, args=(worker,), name="okt-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            yield item
    finally:
        stop.set()
        t.join()
    if err:
        raise err[0]
