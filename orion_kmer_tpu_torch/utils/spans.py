"""Spans and counts at the port's layer boundaries, kept while a
``torch.profiler`` records.

    with spans.span("engine.fetch", bytes=n):
        ...
    with spans.span("ingest.parse") as sp:
        codes = next(it)
        sp.add("positions", codes.shape[0])
    spans.count("k2.bytes", n)
    for batch in spans.each(batches, "engine.wait"):  # each next() a span
        ...
    recording = spans.take()  # (spans, counts), and the store cleared

A span keeps its name, the CLI call it belongs to (the id of its root:
one ``cli.call`` a ``cli.main``), its parent, its thread, its start and
end on ``time.monotonic_ns`` and its counts.  While it is open it also
holds a ``torch.profiler.record_function`` range of its name, so it lies
on the profiler's timeline beside the kernels: a ``--trace`` shows it in
Perfetto, and a benchmark maps the monotonic clock onto the trace's.
``count`` adds to the innermost open span's counts (so a count lands in
the layer and the call that did the work), or to the recording's own
where no span is open.  A thread started under a span runs under a copy
of its context (``host._prefetch``), so its spans share the call and the
parent.

Nothing is kept unless a profiler records (``recording()``): ``span``
then returns one shared null context, and ``count`` returns at once.
Spans are held in memory until ``take``, at most ``CAP`` (a ``count``
of 1 Gbp of reads keeps ~300); past it the recorder keeps no more,
counts them under ``spans.dropped`` and logs a warning at the first.  A
span's self time is its duration less what its children cover.
"""

from __future__ import annotations

import contextvars
import itertools
import logging
import sys
import threading
import time
from typing import NamedTuple

CAP = 1 << 16
DROPPED = "spans.dropped"

logger = logging.getLogger("orion_kmer_tpu_torch.spans")


class Span(NamedTuple):
    """A finished span; times in ``time.monotonic_ns``."""

    name: str
    id: int
    call: int  # the id of its root span
    parent: int | None
    thread: int  # threading.get_ident()
    thread_name: str
    start_ns: int
    end_ns: int
    counts: dict[str, int]


class Recording(NamedTuple):
    spans: list[Span]
    counts: dict[str, int]  # those counted with no span open, and spans.dropped


_current: contextvars.ContextVar = contextvars.ContextVar("orion_kmer_tpu_torch.span", default=None)
_ids = itertools.count(1)
_lock = threading.Lock()
_kept: list[Span] = []
_loose: dict[str, int] = {}


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process (none can
    before torch is imported)."""
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and getattr(profiler, "_is_profiler_enabled", False)


def _add(counts: dict[str, int], key: str, n: int) -> None:
    with _lock:
        counts[key] = counts.get(key, 0) + n


class _Null:
    """The span of a ``span`` call made while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def add(self, key: str, n: int) -> None:
        pass


NULL = _Null()


class _Open:
    __slots__ = ("name", "counts", "id", "call", "parent", "start_ns", "_token", "_range")

    def __init__(self, name: str, counts: dict[str, int]):
        self.name = name
        self.counts = counts

    def __enter__(self):
        up = _current.get()
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.call = self.id if up is None else up.call
        self._token = _current.set(self)
        self._range = sys.modules["torch.autograd.profiler"].record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.monotonic_ns()
        self._range.__exit__(*exc)
        _current.reset(self._token)
        t = threading.current_thread()
        done = Span(self.name, self.id, self.call, self.parent, t.ident, t.name, self.start_ns, end_ns, self.counts)
        with _lock:
            if len(_kept) < CAP:
                _kept.append(done)
                return
            dropped = _loose[DROPPED] = _loose.get(DROPPED, 0) + 1
        if dropped == 1:
            logger.warning("spans: %d kept and none taken; dropping the rest (counted under %s)", CAP, DROPPED)

    def add(self, key: str, n: int) -> None:
        """Add ``n`` to this span's count ``key``."""
        _add(self.counts, key, n)


def span(name: str, **counts: int):
    """A context manager that keeps a span of ``name`` with ``counts``
    while a profiler records; the shared null context otherwise.  Either
    has ``add(key, n)``."""
    if not recording():
        return NULL
    return _Open(name, counts)


def count(name: str, n: int) -> None:
    """Add ``n`` to the count ``name`` of the innermost open span, or of
    the recording where none is open; nothing while nothing records."""
    if not recording():
        return
    up = _current.get()
    _add(_loose if up is None else up.counts, name, n)


def each(items, name: str, counted=None):
    """``items`` with each ``next()`` on them under a span of ``name``;
    ``counted(item, span)``, where given, adds an item's counts to the
    span that fetched it.  Closing this generator closes ``items``."""
    it = iter(items)
    end = object()
    try:
        while True:
            with span(name) as sp:
                item = next(it, end)
                if counted is not None and item is not end:
                    counted(item, sp)
            if item is end:
                return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def take() -> Recording:
    """The spans and counts kept since the last ``take``, cleared."""
    global _kept, _loose
    with _lock:
        out = Recording(_kept, _loose)
        _kept, _loose = [], {}
    return out
