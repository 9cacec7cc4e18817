"""ctypes binding for the native C++ FASTA/FASTQ tokenizer.

The port's own copy of ``orion_kmer_tpu/ingest/native.py``.  It compiles
``fastx.cpp`` beside this module on first use (g++ -O3) into
``build/okt_torch_native/<hash of the source>/`` at the repository root
(``$ORION_KMER_BUILD_DIR/okt_torch_native/...`` where that is set), and
exposes ``parse_fastx_packed``: one C pass over a decompressed
buffer producing the full 2-bit code stream with inter-record
separators, per-record offsets, and ids -- the zero-Python-per-record
ingest path.

Falls back cleanly: callers check ``available()`` and use the pure
Python parser otherwise.  Disable with ORION_KMER_NATIVE=0.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..errors import ContextError

logger = logging.getLogger("orion_kmer_tpu_torch.ingest.native")

_SRC = Path(__file__).resolve().parent / "fastx.cpp"
# where the library is built: ORION_KMER_BUILD_DIR, read at each build,
# else build/ at the repository root
_DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"

_lock = threading.Lock()
_lib = None
_lib_failed = False

OKT_OK = 0
OKT_EMPTY = -1
OKT_UNKNOWN_FORMAT = -2
OKT_MALFORMED = -3
OKT_CAPACITY = -4
OKT_BADCOUNT = -5

_ERROR_NAMES = {
    OKT_EMPTY: "empty input",
    OKT_UNKNOWN_FORMAT: "unknown format (expected '>' or '@')",
    OKT_MALFORMED: "malformed record",
    OKT_CAPACITY: "output capacity exceeded",
    OKT_BADCOUNT: "non-positive count (corrupted table)",
}


def _compile() -> Path:
    src = _SRC.read_bytes()
    build_dir = Path(os.environ.get("ORION_KMER_BUILD_DIR", _DEFAULT_BUILD_DIR))
    out_dir = build_dir / "okt_torch_native" / hashlib.sha256(src).hexdigest()[:16]
    so_path = out_dir / "libokt_fastx.so"
    if so_path.exists():
        return so_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libokt_fastx.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(_SRC)]
    logger.info("Compiling native ingest: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so_path)
    return so_path


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("ORION_KMER_NATIVE", "1") == "0" or not _SRC.exists():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_compile()))
            lib.okt_parse_fastx.restype = ctypes.c_long
            lib.okt_parse_fastx.argtypes = [
                ctypes.c_char_p,  # data
                ctypes.c_long,  # len
                ctypes.c_int,  # normalize
                ctypes.c_long,  # sep
                ctypes.c_int,  # eof
                ctypes.c_void_p,  # codes
                ctypes.c_long,  # codes_cap
                ctypes.c_void_p,  # rec_code_end
                ctypes.c_void_p,  # id_blob
                ctypes.c_long,  # id_cap
                ctypes.c_void_p,  # id_end
                ctypes.c_long,  # max_records
                ctypes.c_void_p,  # out
            ]
            lib.okt_pack_wire.restype = ctypes.c_long
            lib.okt_pack_wire.argtypes = [
                ctypes.c_void_p,  # codes
                ctypes.c_long,  # n
                ctypes.c_long,  # size
                ctypes.c_void_p,  # lanes
                ctypes.c_void_p,  # invalid_words
            ]
            lib.okt_merge_unique.restype = ctypes.c_long
            lib.okt_merge_unique.argtypes = [
                ctypes.c_void_p,  # v1
                ctypes.c_void_p,  # c1
                ctypes.c_long,  # n1
                ctypes.c_void_p,  # v2
                ctypes.c_void_p,  # c2
                ctypes.c_long,  # n2
                ctypes.c_void_p,  # out_v
                ctypes.c_void_p,  # out_c
            ]
            lib.okt_merge_unique_kway.restype = ctypes.c_long
            lib.okt_merge_unique_kway.argtypes = [
                ctypes.c_void_p,  # vs (uint64_t**)
                ctypes.c_void_p,  # cs (int64_t**)
                ctypes.c_void_p,  # ns (long*)
                ctypes.c_long,  # r
                ctypes.c_void_p,  # out_v
                ctypes.c_void_p,  # out_c
            ]
            lib.okt_write_counts_tsv.restype = ctypes.c_long
            lib.okt_write_counts_tsv.argtypes = [
                ctypes.c_void_p,  # vals
                ctypes.c_void_p,  # counts
                ctypes.c_long,  # n
                ctypes.c_int,  # k
                ctypes.c_void_p,  # out
                ctypes.c_long,  # cap
            ]
            lib.okt_render_counts.restype = ctypes.c_long
            lib.okt_render_counts.argtypes = [
                ctypes.c_void_p,  # vals
                ctypes.c_void_p,  # counts
                ctypes.c_long,  # n
                ctypes.c_int,  # k
                ctypes.c_int64,  # min_count
                ctypes.c_void_p,  # out (null: no render)
                ctypes.c_long,  # cap
                ctypes.c_void_p,  # hist (null: no histogram)
                ctypes.c_long,  # hist_cap
                ctypes.c_void_p,  # n_outside (long*)
            ]
            lib.okt_pack_wire_multi.restype = ctypes.c_long
            lib.okt_pack_wire_multi.argtypes = [
                ctypes.c_void_p,  # codes
                ctypes.c_void_p,  # invalid
                ctypes.c_long,  # n_rows
                ctypes.c_long,  # stride
                ctypes.c_long,  # size
                ctypes.c_void_p,  # lanes
                ctypes.c_void_p,  # invalid_words
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            logger.warning("Native ingest unavailable (%s); using Python parser", e)
            _lib_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


class NativeParseError(ContextError):
    def __init__(self, code: int, source: str):
        self.code = code
        super().__init__(
            f"Failed to parse FASTA/Q content from: {source}: "
            f"{_ERROR_NAMES.get(code, f'error {code}')}"
        )


class ParsedChunk(NamedTuple):
    """One native parse of a buffer: the complete records' codes
    (separated by k-1 invalid bytes), each record's code end, the records'
    ids as one blob with each id's end, and the bytes consumed."""

    codes: np.ndarray  # uint8 [N]
    rec_ends: np.ndarray  # int64 [R]
    id_blob: bytes
    id_ends: np.ndarray  # int64 [R]
    consumed: int

    def ids(self) -> list[bytes]:
        """The records' ids as a list of bytes (Python work for each
        record, so built only for the callers that use ids)."""
        starts = [0, *self.id_ends[:-1].tolist()]
        blob = self.id_blob
        return [blob[s:e] for s, e in zip(starts, self.id_ends.tolist())]


# First guess of the records in a buffer: one per 16 bytes (a FASTQ record
# of a 1 bp read takes 10).  A buffer with more retries with an exact
# bound, so the common case scans nothing under the GIL before the parse.
_BYTES_PER_RECORD_GUESS = 16


def _parse_into(lib, ptr, n, k, normalize, eof, max_records):
    sep = k - 1
    codes_cap = n + sep * max_records + sep
    codes = np.empty(codes_cap, dtype=np.uint8)
    rec_end = np.empty(max_records, dtype=np.int64)
    id_blob = np.empty(n + 1, dtype=np.uint8)
    id_end = np.empty(max_records, dtype=np.int64)
    out = np.zeros(4, dtype=np.int64)
    rc = lib.okt_parse_fastx(
        ptr,
        n,
        1 if normalize else 0,
        sep,
        1 if eof else 0,
        codes.ctypes.data_as(ctypes.c_void_p),
        codes_cap,
        rec_end.ctypes.data_as(ctypes.c_void_p),
        id_blob.ctypes.data_as(ctypes.c_void_p),
        n + 1,
        id_end.ctypes.data_as(ctypes.c_void_p),
        max_records,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return rc, codes, rec_end, id_blob, id_end, out


def parse_fastx_raw(
    data,
    k: int,
    normalize: bool = True,
    eof: bool = True,
    source: str = "<bytes>",
) -> ParsedChunk:
    """``parse_fastx_chunk`` without the Python list of ids: ``data`` is
    ``bytes`` or a contiguous uint8 array, and the call holds the GIL only
    around the native parse, so parses on several threads overlap."""
    lib = _load()
    assert lib is not None, "native ingest not available"
    if isinstance(data, np.ndarray):
        n = data.shape[0]
        ptr = data.ctypes.data_as(ctypes.c_char_p)
    else:
        n = len(data)
        ptr = data
    if n == 0:
        if eof:
            raise NativeParseError(OKT_EMPTY, source)
        empty = np.empty(0, np.int64)
        return ParsedChunk(np.empty(0, np.uint8), empty, b"", empty, 0)
    # The parse runs the same way under any capacity until it exceeds one,
    # so a result other than OKT_CAPACITY under the guess is the result
    # under the exact bound.  Exact: every record after the first starts
    # with "\n>" or "\n@".
    guess = max(n // _BYTES_PER_RECORD_GUESS + 2, 4)
    rc, codes, rec_end, id_blob, id_end, out = _parse_into(lib, ptr, n, k, normalize, eof, guess)
    if rc == OKT_CAPACITY:
        raw = data.tobytes() if isinstance(data, np.ndarray) else data
        exact = max(raw.count(b"\n>") + raw.count(b"\n@") + 2, 4)
        rc, codes, rec_end, id_blob, id_end, out = _parse_into(lib, ptr, n, k, normalize, eof, exact)
    if rc != OKT_OK:
        raise NativeParseError(int(rc), source)
    n_records, codes_len, id_len = int(out[0]), int(out[1]), int(out[2])
    return ParsedChunk(
        codes[:codes_len],
        rec_end[:n_records].copy(),
        id_blob[:id_len].tobytes(),
        id_end[:n_records].copy(),
        int(out[3]),
    )


def parse_fastx_chunk(
    data: bytes,
    k: int,
    normalize: bool = True,
    eof: bool = True,
    source: str = "<bytes>",
):
    """Incremental parse + pack of one stream chunk in one native pass.

    With eof=False the trailing incomplete record is rolled back and the
    returned ``consumed`` byte count tells the caller what prefix was
    parsed (carry ``data[consumed:]`` into the next chunk) -- the
    streaming contract of the reference's BufRead per-record loop
    (utils.rs:125-152, count.rs:63-79), keeping memory O(chunk).

    Returns (codes uint8[N], rec_code_end int64[R], ids list[bytes],
    consumed int): codes holds the complete records' 2-bit codes
    separated by k-1 invalid bytes; rec_code_end[i] is the end offset of
    record i's bases in codes.
    """
    p = parse_fastx_raw(data, k, normalize=normalize, eof=eof, source=source)
    return p.codes, p.rec_ends, p.ids(), p.consumed


def parse_fastx_packed(
    data: bytes, k: int, normalize: bool = True, source: str = "<bytes>"
):
    """Whole-buffer parse + pack (eof semantics; see parse_fastx_chunk)."""
    codes, rec_end, ids, _consumed = parse_fastx_chunk(
        data, k, normalize=normalize, eof=True, source=source
    )
    return codes, rec_end, ids


def merge_unique(v1, c1, v2, c2):
    """Native merge of two sorted-unique (vals u64, counts i64) runs,
    summing counts of shared values.  ~100x the numpy searchsorted
    interleave on the 1-core host (see engine._merge_sorted_unique_runs,
    which calls this when available)."""
    lib = _load()
    assert lib is not None, "native ingest not available"
    v1 = np.ascontiguousarray(v1, dtype=np.uint64)
    v2 = np.ascontiguousarray(v2, dtype=np.uint64)
    c1 = np.ascontiguousarray(c1, dtype=np.int64)
    c2 = np.ascontiguousarray(c2, dtype=np.int64)
    n1, n2 = v1.shape[0], v2.shape[0]
    out_v = np.empty(n1 + n2, dtype=np.uint64)
    out_c = np.empty(n1 + n2, dtype=np.int64)
    _advise_hugepages(out_v)
    _advise_hugepages(out_c)
    n = lib.okt_merge_unique(
        v1.ctypes.data_as(ctypes.c_void_p),
        c1.ctypes.data_as(ctypes.c_void_p),
        n1,
        v2.ctypes.data_as(ctypes.c_void_p),
        c2.ctypes.data_as(ctypes.c_void_p),
        n2,
        out_v.ctypes.data_as(ctypes.c_void_p),
        out_c.ctypes.data_as(ctypes.c_void_p),
    )
    if n == n1 + n2:
        return out_v, out_c
    return _trim(out_v, n), _trim(out_c, n)


def _trim(arr: np.ndarray, n: int) -> np.ndarray:
    """Exact-size copy of a merge output's valid prefix, with the copy
    target hugepage-advised too (a plain arr[:n].copy() first-touches a
    second full-size buffer through 4 KB faults, clawing back much of
    the single-allocation win)."""
    out = np.empty(n, dtype=arr.dtype)
    _advise_hugepages(out)
    np.copyto(out, arr[:n])
    return out


# Past this, the O(N*r) linear head scan of the k-way merge loses to a
# pairwise reduction; the accumulator's consolidation keeps r far below
# it in practice.
MAX_KWAY = 32

_MADV_HUGEPAGE = 14
_libc = None


def _advise_hugepages(arr: np.ndarray) -> None:
    """madvise(MADV_HUGEPAGE) a fresh numpy buffer before first touch.

    First-touch page faults dominate large merge outputs on a one-core host
    (measured ~4.4 s to fault 640 MB vs ~0.3 s to write it); with THP in
    madvise mode (a common kernel default) 2 MB pages cut the fault count
    512x (~2-3x measured wall win).  Best-effort: silently a no-op when
    libc/THP are unavailable."""
    global _libc
    try:
        if _libc is None:
            _libc = ctypes.CDLL("libc.so.6", use_errno=True)
        page = 4096
        addr = arr.ctypes.data
        aligned = (addr + page - 1) // page * page
        length = arr.nbytes - (aligned - addr)
        if length > 1 << 22:
            _libc.madvise(
                ctypes.c_void_p(aligned),
                ctypes.c_size_t(length),
                ctypes.c_int(_MADV_HUGEPAGE),
            )
    except OSError:  # pragma: no cover - platform without libc semantics
        pass


def merge_unique_kway(vals: list, counts: list):
    """Native k-way merge of r sorted-unique (vals u64, counts i64)
    runs in one pass -- one output allocation total (first-touch page
    faults on fresh buffers cost ~10x the merge scan on a one-core VM, so a
    pairwise reduction pays them once per level)."""
    lib = _load()
    assert lib is not None, "native ingest not available"
    r = len(vals)
    assert 1 <= r <= MAX_KWAY
    vs = [np.ascontiguousarray(v, dtype=np.uint64) for v in vals]
    cs = [np.ascontiguousarray(c, dtype=np.int64) for c in counts]
    ns = np.array([v.shape[0] for v in vs], dtype=np.int64)
    total = int(ns.sum())
    vptrs = np.array([v.ctypes.data for v in vs], dtype=np.uintp)
    cptrs = np.array([c.ctypes.data for c in cs], dtype=np.uintp)
    out_v = np.empty(total, dtype=np.uint64)
    out_c = np.empty(total, dtype=np.int64)
    _advise_hugepages(out_v)
    _advise_hugepages(out_c)
    n = lib.okt_merge_unique_kway(
        vptrs.ctypes.data_as(ctypes.c_void_p),
        cptrs.ctypes.data_as(ctypes.c_void_p),
        ns.ctypes.data_as(ctypes.c_void_p),
        r,
        out_v.ctypes.data_as(ctypes.c_void_p),
        out_c.ctypes.data_as(ctypes.c_void_p),
    )
    if n == total:
        return out_v, out_c
    return _trim(out_v, n), _trim(out_c, n)


def counts_tsv_bytes(
    vals: np.ndarray, counts: np.ndarray, k: int, out: np.ndarray | None = None
) -> memoryview:
    """Render `KMER\\tCOUNT\\n` lines natively; byte-identical to the
    Python codec.u64s_to_seqs path (measured 0.83M -> ~7M lines/s on
    this 1-core host, ~8.4x).  Counts <= 0 raise (OKT_BADCOUNT):
    pipeline counts are >= 1, so a non-positive value is corruption.

    Pass ``out`` (uint8, >= n*(k+22) bytes) to reuse one buffer across
    chunks -- a fresh ~90 MB allocation per chunk re-pays first-touch
    page faults that cost multiples of the render itself here."""
    lib = _load()
    assert lib is not None, "native ingest not available"
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n = vals.shape[0]
    if out is None:
        out = np.empty(n * (k + 22), dtype=np.uint8)
        _advise_hugepages(out)
    else:
        assert out.dtype == np.uint8 and out.shape[0] >= n * (k + 22)
    m = lib.okt_write_counts_tsv(
        vals.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        n,
        k,
        out.ctypes.data_as(ctypes.c_void_p),
        out.shape[0],
    )
    if m < 0:
        raise NativeParseError(int(m), "<counts_tsv>")
    return memoryview(out.data)[: int(m)]


# The fused tail of `count` (``render_counts``).  Its histogram is dense
# for multiplicities 1..HIST_CAP, and counts outside that go through
# np.unique: high-coverage inputs do hold k-mers counted more often.  A
# chunk of RENDER_ROWS rows renders into a buffer of RENDER_ROWS * (k +
# 22) bytes (13.9 MB at k = 31), and at most one chunk more than there
# are render threads is alive: 9 at MAX_RENDER_THREADS, ~125 MB, about
# the one 2^21-row buffer (111 MB) of the serial render before it.
HIST_CAP = 1 << 16
RENDER_ROWS = 1 << 18
MAX_RENDER_THREADS = 8
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


def render_counts(write, vals, counts, k: int, min_count: int | None = None,
                  histogram: bool = False, threads: int = 1):
    """`count`'s tail in one native pass over sorted (vals u64, counts
    i64) rows, with the bytes and rows of the numpy filter, ``np.unique``
    and ``counts_tsv_bytes``: the `KMER\\tCOUNT\\n` lines of the rows with
    count >= ``min_count`` (every row when None) go to ``write`` in row
    order, and with ``histogram`` the histogram of every row's count,
    taken before the filter, is returned as (multiplicities ascending,
    rows counted that many times), two int64 arrays (else None).
    ``write`` gets a view of a buffer that is rendered into again once it
    returns, as a file's write allows.

    Chunks of RENDER_ROWS rows render on ``threads`` threads (at most
    MAX_RENDER_THREADS; one: inline) while the chunks before them are
    written, strictly in order.  A buffer is written before it is
    rendered into again, and holds its own histogram.  A kept
    count <= 0 raises NativeParseError (OKT_BADCOUNT) before its chunk
    is written."""
    lib = _load()
    assert lib is not None, "native ingest not available"
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n = vals.shape[0]
    if counts.shape != (n,):
        raise ValueError(f"render_counts: {n} values but counts of shape {counts.shape}")
    render = min_count is None or min_count <= _INT64_MAX
    keep_from = _INT64_MIN if min_count is None else min(max(min_count, _INT64_MIN), _INT64_MAX)
    rows = min(RENDER_ROWS, max(n, 1))
    threads = max(1, min(threads, MAX_RENDER_THREADS, -(-n // rows)))
    slots = []
    for _ in range(threads + 1 if threads > 1 else 1):
        buf = np.empty(rows * (k + 22) if render else 0, np.uint8)
        _advise_hugepages(buf)
        slots.append((buf, np.zeros(HIST_CAP + 1 if histogram else 0, np.int64), np.zeros(1, np.int64)))
    outside = []

    def run(slot, lo: int, hi: int) -> int:
        buf, hist, n_outside = slot
        return lib.okt_render_counts(
            vals.ctypes.data + 8 * lo, counts.ctypes.data + 8 * lo, hi - lo, k, keep_from,
            buf.ctypes.data if render else None, buf.shape[0],
            hist.ctypes.data if histogram else None, HIST_CAP, n_outside.ctypes.data,
        )

    def finish(m: int, slot, lo: int, hi: int) -> None:
        if m < 0:
            raise NativeParseError(int(m), "<counts_tsv>")
        if m:
            write(memoryview(slot[0].data)[:m])
        if histogram and slot[2][0]:
            c = counts[lo:hi]
            outside.append(c[(c < 1) | (c > HIST_CAP)])

    chunks = [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]
    if threads == 1:
        for lo, hi in chunks:
            finish(run(slots[0], lo, hi), slots[0], lo, hi)
    else:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        free, pending = list(slots), deque()
        pool = ThreadPoolExecutor(threads, thread_name_prefix="okt-render")
        try:
            for lo, hi in chunks:
                if not free:
                    fut, slot, a, b = pending.popleft()
                    finish(fut.result(), slot, a, b)
                    free.append(slot)
                slot = free.pop()
                pending.append((pool.submit(run, slot, lo, hi), slot, lo, hi))
            while pending:
                fut, slot, a, b = pending.popleft()
                finish(fut.result(), slot, a, b)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    if not histogram:
        return None
    dense = sum(hist for _, hist, _ in slots)
    mult = np.flatnonzero(dense)
    if outside:
        # counts outside 1..HIST_CAP: below the dense ones or above them
        om, of = np.unique(np.concatenate(outside), return_counts=True)
        below = om < 1
        return (np.concatenate([om[below], mult, om[~below]]),
                np.concatenate([of[below], dense[mult], of[~below]]))
    return mult, dense[mult]


def pack_wire(codes: np.ndarray, size: int, out=None):
    """Native wire-format packing: codes u8[n] (255 = invalid), padded to
    ``size`` -> (lanes u32[size/16], invalid u32[size/32]).  Same output
    as engine.pack_for_transfer's numpy path, ~5x faster single-core.
    ``out``: a (lanes, invalid) pair of contiguous u32 arrays of exactly
    those lengths to write into (pinned staging buffers) instead of new
    arrays."""
    lib = _load()
    assert lib is not None, "native ingest not available"
    assert size % 32 == 0
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    if out is None:
        lanes = np.empty(size // 16, dtype=np.uint32)
        inv = np.empty(size // 32, dtype=np.uint32)
    else:
        lanes, inv = out
        assert lanes.shape == (size // 16,) and inv.shape == (size // 32,)
        assert lanes.flags.c_contiguous and inv.flags.c_contiguous
    rc = lib.okt_pack_wire(
        codes.ctypes.data_as(ctypes.c_void_p),
        n,
        size,
        lanes.ctypes.data_as(ctypes.c_void_p),
        inv.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != OKT_OK:
        raise NativeParseError(int(rc), "<pack_wire>")
    return lanes, inv
