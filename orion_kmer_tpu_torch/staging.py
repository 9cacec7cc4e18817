"""The host <-> device link: the one module that decides how a tensor
crosses it.

Batches go to the device through ``PinnedRing``: ``staged_batches``
(count, sketch) and ``query_batches`` (query) parse, cut, wire-pack and
stage them, on the prefetch thread their consumers run them on.
``to_device`` copies one wire array.  Results come back through
``to_host``, on a card into pinned memory with one synchronisation;
``fetch_table`` is a count table's fetch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .host import (
    _bucket,
    _prefetch,
    _rebatch_records,
    native_chunks,
    pack_for_transfer,
    parse_spans,
    parse_threads,
    stream_file_codes,
    wire_size,
)
from .keys import flip
from .utils import spans


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A u32 wire array as an int32 tensor on ``device``: pinned and
    copied without blocking on CUDA, a zero-copy view on the CPU."""
    t = torch.from_numpy(arr.view(np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_host(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Tensors of one device as host arrays.  From a card each is copied
    without blocking into pinned host memory, all in flight at once, with
    one synchronisation; the arrays own that memory.  A CPU tensor gives
    its own memory."""
    device = tensors[0].device
    if device.type == "cpu":
        return tuple(t.numpy() for t in tensors)
    if device.type != "cuda":
        raise ValueError(f"to_host: tensors on {device}, not cpu or cuda")
    host = []
    for t in tensors:  # each copy starts before the next buffer is taken
        host.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
        host[-1].copy_(t, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return tuple(h.numpy() for h in host)


def fetch_table(keys: torch.Tensor, counts: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A count table's (flipped int64 keys, int64 counts) tensors -> (u64
    values, int64 counts) on the host: the sign flipped on the keys'
    device, then both planes ``to_host``.  An ``engine.fetch`` span
    counts the bytes of both planes."""
    with spans.span("engine.fetch", bytes=16 * keys.shape[0]):
        host_keys, host_counts = to_host(flip(keys), counts)
        return host_keys.view(np.uint64), host_counts


class PinnedRing:
    """Wire batches (and a query batch's record starts) packed into host
    buffers and copied to the device without blocking.

    On a card the buffers are a ring of ``SLOTS`` pinned ones; a buffer is
    packed again only once the copy that last read it has completed (its
    CUDA event).  On the CPU each batch is packed into new buffers, which
    the tensors returned are, so a caller may keep every batch.  A batch
    is packed in ``parts`` slices of whole wire words at once (the parser
    threads, -t), on threads of the ring's own: the native packer releases
    the GIL."""

    SLOTS = 3

    def __init__(self, device: torch.device, parts: int = 1):
        from concurrent.futures import ThreadPoolExecutor

        self.device = device
        self.parts = parts
        self._card = device.type == "cuda"
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

    def _buffers(self, size: int, m: int | None):
        """Host buffers for one batch of ``size`` positions and ``m``
        record starts (None: no starts): (lanes, invalid words, starts or
        None, the event to record once the copies are enqueued, or None).
        On a card they are the next slot's, after the wait for its last
        copy."""
        if not self._card:
            starts = None if m is None else torch.empty(m, dtype=torch.int64)
            return torch.empty(size // 16, dtype=torch.int32), torch.empty(size // 32, dtype=torch.int32), starts, None
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
        if m is not None and (slot[3] is None or slot[3].shape[0] < m):
            slot[3] = torch.empty(_bucket(m), dtype=torch.int64, pin_memory=True)
        return slot[0][: size // 16], slot[1][: size // 32], None if m is None else slot[3][:m], slot[2]

    def stage(self, codes: np.ndarray, size: int, starts: np.ndarray | None = None):
        """Pack ``codes`` at wire size ``size`` and start its copy to the
        device: (lanes, invalid words) there, and ``starts`` (int64)
        copied beside them when given.  On a card under an
        ``ingest.stage`` span, with the wait for the slot's last copy: the
        span is the pinned ring's cost, which the CPU does not have."""
        with spans.span("ingest.stage") if self._card else spans.NULL:
            lanes, inv, lo, done = self._buffers(size, None if starts is None else starts.shape[0])
            self._pack(codes, size, lanes.numpy().view(np.uint32), inv.numpy().view(np.uint32))
            staged = lanes.to(self.device, non_blocking=True), inv.to(self.device, non_blocking=True)
            if starts is not None:
                lo.numpy()[:] = starts
                staged += (lo.to(self.device, non_blocking=True),)
            if done is not None:
                done.record(torch.cuda.current_stream(self.device))
            return staged


def staged_batches(path, k: int, normalize: bool, batch: int, device):
    """Parse, wire-pack (at ``_bucket`` sizes: the forest's levels are
    powers of two) and stage the count batches of a file through a
    ``PinnedRing``: (lanes, invalid words, size, n) each.  Run on the
    prefetch thread, so the host-to-device copy is enqueued before the
    consumer needs the batch."""
    ring = PinnedRing(device, parse_threads())
    try:
        for codes in parse_spans(stream_file_codes(path, k, normalize, batch), k):
            n = codes.shape[0]
            size = _bucket(n)
            yield *ring.stage(codes, size), size, n
    finally:
        ring.close()


class QueryBatch(NamedTuple):
    """One query batch as ``query_batches`` stages it."""

    lanes: torch.Tensor | None  # int32 wire lanes on the device; None: no positions, records only
    inv_words: torch.Tensor | None  # int32 invalid words on the device
    size: int  # wire positions, a multiple of 32
    n: int  # real positions
    starts: torch.Tensor | None  # int64 batch-local record starts, clamped at 0, on the device
    first_rid: int  # global index of the batch's first record
    records: list  # (id blob, id ends, lengths) of each chunk parsed since the previous batch


def stage_query(ring: PinnedRing, piece: np.ndarray, starts: np.ndarray):
    """One query batch through ``ring`` at its wire size (``wire_size``):
    (lanes, invalid words, size, n, starts clamped at 0) on the device."""
    n = piece.shape[0]
    size = wire_size(n)
    lanes, inv_words, lo = ring.stage(piece, size, np.maximum(starts, 0))
    return lanes, inv_words, size, n, lo


def query_batches(path, k: int, batch: int, device):
    """Parse (raw bytes, on the -t parser threads), cut
    (``host._rebatch_records``), wire-pack and stage the query batches of
    a file through a ``PinnedRing`` (the pack split over the parser
    threads); run on the prefetch thread, so the host-to-device copies
    are enqueued before the consumer needs them, as ``staged_batches``
    does for counting."""
    device = torch.device(device)
    threads = parse_threads()
    ring = PinnedRing(device, threads)
    chunks = native_chunks(path, k, normalize=False, threads=threads)
    if threads > 1:
        chunks = _prefetch(chunks, depth=2)  # the pieces checked and ordered on a thread of their own
    stream = ((p.codes, p.rec_ends, (p.id_blob, p.id_ends)) for p in chunks)
    cuts = parse_spans(_rebatch_records(stream, k, batch), k, lambda cut: cut[0].shape[0])
    try:
        for piece, starts, rids, new in cuts:
            records = [(blob, ends, lens) for (blob, ends), lens in new]
            if piece.shape[0] == 0:
                yield QueryBatch(None, None, 0, 0, None, 0, records)
            else:
                yield QueryBatch(*stage_query(ring, piece, starts), int(rids[0]), records)
    finally:
        ring.close()
