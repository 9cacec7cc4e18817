"""Digests of large outputs, and the named pipes that carry them.

A command's large output (a count TSV, a k-mer database, the ids of a
query) goes to a named pipe that a thread of the benchmark drains, as a
downstream tool would read it; the disk sees none of it.  What is kept of
each stream is its tree digest: SHA-256 of each 16 MiB block, hashed on a
small pool of threads (hashlib releases the GIL), then SHA-256 of the
block digests and the length.  The reference digests its own bytes the
same way, so two streams compare by their digests alone.
"""

from __future__ import annotations

import hashlib
import os
import queue
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor

BLOCK = 1 << 24
_BUFFERS = 24  # blocks in flight at once: 384 MiB


def _block_digest(view) -> bytes:
    return hashlib.sha256(view).digest()


def _finish(block_digests: list[bytes], n_bytes: int) -> str:
    h = hashlib.sha256()
    for d in block_digests:
        h.update(d)
    h.update(n_bytes.to_bytes(8, "little"))
    return h.hexdigest()[:32]


def tree_digest(data, pool: ThreadPoolExecutor | None = None) -> str:
    """The tree digest of a bytes-like object, its blocks hashed on
    ``pool`` when given."""
    view = memoryview(data).cast("B")
    blocks = [view[i : i + BLOCK] for i in range(0, view.nbytes, BLOCK)]
    digests = list(pool.map(_block_digest, blocks)) if pool else [_block_digest(b) for b in blocks]
    return _finish(digests, view.nbytes)


class Pending:
    """A stream's digest whose blocks may still be hashing."""

    def __init__(self, futures: list[Future], n_bytes: int, error: str | None = None):
        self._futures = futures
        self.n_bytes = n_bytes
        self.error = error

    def result(self) -> str | None:
        if self.error is not None:
            return None
        return _finish([f.result() for f in self._futures], self.n_bytes)


class _Blocks:
    """Fills 16 MiB buffers from a stream and hands each full one to the
    pool; a buffer is filled again only once its hash is done."""

    def __init__(self, pool: ThreadPoolExecutor, free: "queue.Queue[bytearray]"):
        self.pool = pool
        self.free = free
        self.futures: list[Future] = []
        self.n_bytes = 0

    def _submit(self, buf: bytearray, n: int) -> None:
        def job(buf=buf, n=n):
            try:
                return _block_digest(memoryview(buf)[:n])
            finally:
                self.free.put(buf)

        self.futures.append(self.pool.submit(job))
        self.n_bytes += n

    def read(self, f, n: int | None = None) -> int:
        """Hash the next ``n`` bytes of ``f`` (all of it when None) as
        blocks of this digest; returns the bytes read."""
        got_total = 0
        while n is None or got_total < n:
            buf = self.free.get()
            want = BLOCK if n is None else min(BLOCK, n - got_total)
            view = memoryview(buf)[:want]
            got = 0
            while got < want:
                r = f.readinto(view[got:])
                if not r:
                    break
                got += r
            if got:
                self._submit(buf, got)
            else:
                self.free.put(buf)
            got_total += got
            if got < want:
                break
        return got_total

    def pending(self) -> Pending:
        return Pending(self.futures, self.n_bytes)


def read_exact(f, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = f.read(n - len(out))
        if not chunk:
            raise EOFError(f"stream ended {n - len(out)} bytes early")
        out += chunk
    return bytes(out)


class PipeSink:
    """A named pipe at ``path`` and the thread that drains it: each
    writer's stream, from its open to its close, is handed to
    ``consume(f, blocks_factory)``, whose result ``collect()`` returns, one
    per stream in order."""

    def __init__(self, path, consume, pool: ThreadPoolExecutor, free: "queue.Queue[bytearray]"):
        self.path = os.fspath(path)
        os.mkfifo(self.path)
        self._consume = consume
        self._pool = pool
        self._free = free
        self._results: "queue.Queue" = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._drain, name="h100bench-drain", daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            with open(self.path, "rb", buffering=0) as f:
                if self._stop:
                    return
                try:
                    result = self._consume(f, lambda: _Blocks(self._pool, self._free))
                except Exception as e:  # a malformed stream is a wrong answer, judged later
                    result = Pending([], 0, error=f"{type(e).__name__}: {e}")
                    while f.read(1 << 20):
                        pass
            self._results.put(result)

    def collect(self, timeout: float = 120.0):
        """The result of the next stream, once its writer has closed it;
        None if no writer wrote one within ``timeout`` seconds."""
        try:
            return self._results.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop = True
        try:
            fd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
            os.close(fd)
        except OSError:
            pass  # no reader: the thread has ended
        self._thread.join(timeout=10)
        try:
            os.unlink(self.path)
        except OSError:
            pass


def buffers() -> "queue.Queue[bytearray]":
    free: "queue.Queue[bytearray]" = queue.Queue()
    for _ in range(_BUFFERS):
        free.put(bytearray(BLOCK))
    return free


def consume_stream(f, blocks_factory) -> Pending:
    """The tree digest of a whole stream."""
    blocks = blocks_factory()
    blocks.read(f)
    return blocks.pending()


class DbDigest:
    """What a KmerDbV2 stream holds: k, and for each reference its name,
    its number of k-mers and the tree digest of their bytes as written."""

    def __init__(self, k: int, refs: dict[str, tuple[int, Pending]]):
        self.k = k
        self.refs = refs

    def result(self) -> dict:
        return {"k": self.k, "refs": {n: (c, p.result()) for n, (c, p) in self.refs.items()}}


_U64 = struct.Struct("<Q")


def consume_bincode_db(f, blocks_factory) -> DbDigest:
    """Read a KmerDbV2 bincode stream (u8 k, u64 count, then per reference
    u64 name length, name, u64 k-mer count, the k-mers as u64 LE) and
    digest each reference's k-mers.  Trailing bytes are an error."""
    k = read_exact(f, 1)[0]
    (n_refs,) = _U64.unpack(read_exact(f, 8))
    refs: dict[str, tuple[int, Pending]] = {}
    for _ in range(n_refs):
        (name_len,) = _U64.unpack(read_exact(f, 8))
        name = read_exact(f, name_len).decode("utf-8")
        (n,) = _U64.unpack(read_exact(f, 8))
        blocks = blocks_factory()
        if blocks.read(f, 8 * n) != 8 * n:
            raise EOFError(f"reference {name!r}: k-mer set cut short")
        refs[name] = (n, blocks.pending())
    if f.read(1):
        raise ValueError("trailing bytes after the last reference")
    return DbDigest(k, refs)
