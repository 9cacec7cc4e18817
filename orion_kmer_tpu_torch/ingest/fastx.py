"""FASTA/FASTQ tokenizer (host side).

Behavioral equivalent of the reference's needletail parser
(``parse_fastx_reader``; count.rs:63, build.rs:42, query.rs:51,
classify.rs:150):

  * format auto-detected from the first non-whitespace byte
    ('>' FASTA, '@' FASTQ)
  * empty or unrecognized input is a hard parse error (the reference
    build/count tests assert failure on 0-byte files,
    build_tests.rs:212-237)
  * FASTA sequences may span multiple lines and are concatenated
  * record id = full header line after '>' / '@' (needletail `id()`)
  * CR stripped (CRLF tolerant)

A native C++ fast path (``native.py``) parses large
buffers; this pure-Python implementation is the reference and fallback.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

from ..errors import ContextError


class FastxParseError(ContextError):
    pass


class Record(NamedTuple):
    id: bytes  # header line without the leading marker
    seq: bytes  # raw sequence bytes (no normalization)


def _strip_cr(line: bytes) -> bytes:
    return line[:-1] if line.endswith(b"\r") else line


def parse_fastx_bytes(data: bytes, source: str = "<bytes>") -> Iterator[Record]:
    """Parse an in-memory FASTA/FASTQ buffer into records."""
    if not data.strip():
        raise FastxParseError(f"Failed to parse FASTA/Q content from: {source}: empty input")
    first = data.lstrip()[:1]
    if first == b">":
        return _parse_fasta(data, source)
    if first == b"@":
        return _parse_fastq(data, source)
    raise FastxParseError(
        f"Failed to parse FASTA/Q content from: {source}: unknown format "
        f"(expected '>' or '@', got {first!r})"
    )


def _parse_fasta(data: bytes, source: str) -> Iterator[Record]:
    header: bytes | None = None
    chunks: list[bytes] = []
    for line in data.split(b"\n"):
        line = _strip_cr(line)
        if line.startswith(b">"):
            if header is not None:
                yield Record(header, b"".join(chunks))
            header = line[1:]
            chunks = []
        elif line:
            if header is None:
                raise FastxParseError(
                    f"Failed to parse FASTA/Q content from: {source}: sequence before header"
                )
            chunks.append(line)
    if header is not None:
        yield Record(header, b"".join(chunks))


def _parse_fastq(data: bytes, source: str) -> Iterator[Record]:
    lines = data.split(b"\n")
    # drop trailing blank lines
    while lines and not _strip_cr(lines[-1]):
        lines.pop()
    i, n = 0, len(lines)
    while i < n:
        head = _strip_cr(lines[i])
        if not head.startswith(b"@"):
            raise FastxParseError(
                f"Failed to parse FASTA/Q content from: {source}: bad FASTQ header at line {i + 1}"
            )
        if i + 3 >= n:
            raise FastxParseError(
                f"Failed to parse FASTA/Q content from: {source}: truncated FASTQ record at line {i + 1}"
            )
        seq = _strip_cr(lines[i + 1])
        plus = _strip_cr(lines[i + 2])
        qual = _strip_cr(lines[i + 3])
        if not plus.startswith(b"+"):
            raise FastxParseError(
                f"Failed to parse FASTA/Q content from: {source}: missing '+' line at line {i + 3}"
            )
        if len(qual) != len(seq):
            raise FastxParseError(
                f"Failed to parse FASTA/Q content from: {source}: quality length mismatch at line {i + 4}"
            )
        yield Record(head[1:], seq)
        i += 4


def _stream_records(f, source: str) -> Iterator[Record]:
    """Line-streaming record parser over an open binary stream: memory is
    O(record), never O(file) (the streaming analog of parse_fastx_bytes;
    reference: needletail over BufRead, count.rs:63-79)."""
    import io

    if not isinstance(f, io.BufferedIOBase):
        # zstd's stream_reader is raw-like: its readline exists but raises
        # io.UnsupportedOperation, so buffer every non-buffered stream
        f = io.BufferedReader(f)
    with f:
        it = iter(f.readline, b"")
        # find the first non-blank line to detect the format
        first = None
        lineno = 0
        for line in it:
            lineno += 1
            if _strip_cr(line.rstrip(b"\n")).strip():
                first = _strip_cr(line.rstrip(b"\n"))
                break
        if first is None:
            raise FastxParseError(
                f"Failed to parse FASTA/Q content from: {source}: empty input"
            )
        if first.startswith(b">"):
            header = first[1:]
            chunks: list[bytes] = []
            for line in it:
                line = _strip_cr(line.rstrip(b"\n"))
                if line.startswith(b">"):
                    yield Record(header, b"".join(chunks))
                    header = line[1:]
                    chunks = []
                elif line:
                    chunks.append(line)
            yield Record(header, b"".join(chunks))
        elif first.startswith(b"@"):
            head = first
            while True:
                seq = f.readline()
                if not seq:
                    raise FastxParseError(
                        f"Failed to parse FASTA/Q content from: {source}: "
                        f"truncated FASTQ record at line {lineno}"
                    )
                seq = _strip_cr(seq.rstrip(b"\n"))
                plus = f.readline()
                qual = f.readline()
                if not plus or not qual:
                    raise FastxParseError(
                        f"Failed to parse FASTA/Q content from: {source}: "
                        f"truncated FASTQ record at line {lineno}"
                    )
                plus = _strip_cr(plus.rstrip(b"\n"))
                qual = _strip_cr(qual.rstrip(b"\n"))
                if not plus.startswith(b"+"):
                    raise FastxParseError(
                        f"Failed to parse FASTA/Q content from: {source}: "
                        f"missing '+' line at line {lineno + 2}"
                    )
                if len(qual) != len(seq):
                    raise FastxParseError(
                        f"Failed to parse FASTA/Q content from: {source}: "
                        f"quality length mismatch at line {lineno + 3}"
                    )
                yield Record(head[1:], seq)
                lineno += 4
                # next record header (tolerating blank lines)
                head = None
                for line in it:
                    lineno += 1
                    line = _strip_cr(line.rstrip(b"\n"))
                    if line.strip():
                        head = line
                        break
                if head is None:
                    return
                if not head.startswith(b"@"):
                    raise FastxParseError(
                        f"Failed to parse FASTA/Q content from: {source}: "
                        f"bad FASTQ header at line {lineno}"
                    )
        else:
            raise FastxParseError(
                f"Failed to parse FASTA/Q content from: {source}: unknown format "
                f"(expected '>' or '@', got {first[:1]!r})"
            )


def parse_fastx_file(path: str | os.PathLike) -> Iterator[Record]:
    """Open (decompressing by extension) and parse a FASTA/FASTQ file,
    streaming records with O(record) memory."""
    from .compress import open_input

    path_str = os.fspath(path)
    try:
        f = open_input(path)
    except ContextError as e:
        raise FastxParseError(f"Failed to get input reader for file: {path_str}", e) from e
    except OSError as e:
        raise FastxParseError(f"Failed to get input reader for file: {path_str}", e) from e

    def gen():
        import gzip
        import lzma

        try:
            yield from _stream_records(f, path_str)
        except (
            OSError,
            EOFError,
            lzma.LZMAError,
            gzip.BadGzipFile,
        ) as e:  # mid-stream decompression errors
            raise FastxParseError(
                f"Failed to read input file: {path_str!r}", e
            ) from e

    return gen()
