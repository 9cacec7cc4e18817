"""Extension-dispatched compressed stream I/O.

Mirrors the reference I/O helpers (orion-kmer/src/utils.rs:125-199):
read-side .gz (multi-member), .xz, .zst/.zstd, else plain; write-side
mirror with gzip default level, xz level 6, zstd default level.
"""

from __future__ import annotations

import gzip
import io
import lzma
import os
from pathlib import Path

from ..errors import ContextError

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - zstandard is baked into the image
    _zstd = None


def _ext(path: str | os.PathLike) -> str:
    # utils.rs:115-119: lowercase final extension
    return Path(path).suffix.lower().lstrip(".")


def open_input(path: str | os.PathLike):
    """Binary read stream with transparent decompression (utils.rs:125-152)."""
    path = os.fspath(path)
    try:
        raw = open(path, "rb")
    except OSError as e:
        raise ContextError(f"Failed to open input file: {path!r}", e) from e
    ext = _ext(path)
    if ext == "gz":
        return gzip.open(raw, "rb")  # gzip handles multi-member like MultiGzDecoder
    if ext == "xz":
        return lzma.open(raw, "rb")
    if ext in ("zst", "zstd"):
        if _zstd is None:
            raise ContextError(f"zstd support unavailable for {path!r}")
        dctx = _zstd.ZstdDecompressor()
        return dctx.stream_reader(raw, closefd=True)
    return raw


def read_bytes(path: str | os.PathLike) -> bytes:
    """Read a whole (possibly compressed) file into memory."""
    with open_input(path) as f:
        try:
            return f.read()
        except (OSError, lzma.LZMAError, gzip.BadGzipFile) as e:
            raise ContextError(f"Failed to read input file: {os.fspath(path)!r}", e) from e


def open_output(path: str | os.PathLike):
    """Binary write stream with transparent compression (utils.rs:167-199)."""
    path = os.fspath(path)
    ext = _ext(path)
    try:
        if ext == "gz":
            return gzip.open(path, "wb", compresslevel=6)  # GzCompression::default()
        if ext == "xz":
            return lzma.open(path, "wb", preset=6)  # XzEncoder::new(file, 6)
        if ext in ("zst", "zstd"):
            if _zstd is None:
                raise ContextError(f"zstd support unavailable for {path!r}")
            cctx = _zstd.ZstdCompressor(level=3)  # zstd crate level 0 == default(3)
            raw = open(path, "wb")
            return cctx.stream_writer(raw, closefd=True)
        return open(path, "wb")
    except OSError as e:
        raise ContextError(f"Failed to create output file: {path!r}", e) from e


class TextOut:
    """Small text adapter over a binary output stream."""

    def __init__(self, path: str | os.PathLike):
        self._bin = open_output(path)
        self._wrap = io.TextIOWrapper(self._bin, encoding="utf-8", newline="\n")

    def __enter__(self):
        return self._wrap

    def __exit__(self, *exc):
        self._wrap.flush()
        self._wrap.close()
        return False
