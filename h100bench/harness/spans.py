"""The port's own spans and counts of a traced window
(``orion_kmer_tpu_torch.utils.spans``), on the device trace's clock.

The port keeps a span while a ``torch.profiler`` records, on
``time.monotonic_ns``.  The window's end on that clock
(``ctx.window.end``) and on the trace's (``ctx.trace.hi``, the end of the
``h100bench.window`` range) map one onto the other:
``t_trace = t_mono - window.end + trace.hi``.  (The window's start would
do as well but for the first ``record_function`` of a process, which
takes its timestamp and then sets itself up, ~1.2 ms on a CPU core,
before the window reads its start.)  The mapping is checked against the
harness's own ranges: each ``h100bench.call`` range has to hold one
``cli.call`` span that starts within ``TOLERANCE_S`` of it, or no span
metric is read; nor is one where the recorder dropped spans.  A checkout
whose port keeps no spans reads None throughout, and so does a run
without a trace.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from . import card

TOLERANCE_S = 1e-3
ROOT = "cli.call"
UNNAMED = "(no span below cli.call)"


def _covered(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    out, t = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, t), min(e, hi)
        if e > s:
            out += e - s
            t = e
    return out


def _minus(lo: float, hi: float, holes) -> list[tuple[float, float]]:
    """[lo, hi] less the union of ``holes``, as sorted disjoint intervals."""
    out, t = [], lo
    for s, e in sorted(holes):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if hi > t:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def idle_in(busy, calls) -> list[tuple[float, float]]:
    """The gaps between the sorted disjoint ``busy`` intervals inside each
    (start, end) of ``calls``, sorted."""
    starts = [b[0] for b in busy]
    out = []
    for cs, ce in calls:
        first = max(0, bisect.bisect_left(starts, cs) - 1)
        inside = [b for b in busy[first : bisect.bisect_right(starts, ce)] if b[1] > cs]
        out += _minus(cs, ce, inside)
    return sorted(out)


class Spans:
    """The spans of one window, in seconds on the trace's clock."""

    def __init__(self, spans, offset_s: float):
        self.spans = spans
        self.offset_s = offset_s
        self.by_id = {s.id: s for s in spans}
        self.children = defaultdict(list)
        for s in spans:
            if s.parent in self.by_id:
                self.children[s.parent].append(s)

    def interval(self, s) -> tuple[float, float]:
        return s.start_ns * 1e-9 + self.offset_s, s.end_ns * 1e-9 + self.offset_s

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def total_s(self, name: str) -> float:
        """The summed duration of the spans of ``name``."""
        return sum((s.end_ns - s.start_ns) * 1e-9 for s in self.named(name))

    def self_s(self, name: str) -> float:
        """The summed self time of the spans of ``name``: each one's
        duration less the part of it that its children cover."""
        total = 0.0
        for s in self.named(name):
            lo, hi = self.interval(s)
            total += hi - lo - _covered([self.interval(c) for c in self.children[s.id]], lo, hi)
        return total

    def count(self, key: str, name: str | None = None) -> int:
        """The summed count ``key`` of every span (of ``name``, where
        given)."""
        return sum(s.counts.get(key, 0) for s in (self.spans if name is None else self.named(name)))

    def idle_by_span(self, busy, calls) -> dict[str, float]:
        """The device's idle time inside ``calls``, each part put down to
        the innermost span open on the CLI's thread (that of the
        ``cli.call`` spans) at the time; ``UNNAMED`` for what lies outside
        every span below ``cli.call``.  Seconds over the whole window."""
        idle = idle_in(busy, calls)
        idle_starts = [g[0] for g in idle]
        threads = {s.thread for s in self.named(ROOT)}
        out: dict[str, float] = defaultdict(float)
        named = 0.0
        for s in self.spans:
            if s.thread not in threads:
                continue
            lo, hi = self.interval(s)
            own = [self.interval(c) for c in self.children[s.id] if c.thread == s.thread]
            for a, b in _minus(lo, hi, own):
                first = max(0, bisect.bisect_left(idle_starts, a) - 1)
                t = 0.0
                for gs, ge in idle[first : bisect.bisect_right(idle_starts, b)]:
                    t += max(0.0, min(ge, b) - max(gs, a))
                if s.name != ROOT:
                    out[s.name] += t
                    named += t
        out[UNNAMED] = sum(e - s for s, e in idle) - named
        return dict(out)


def _mapped(ctx):
    if ctx.trace is None or ctx.window is None:
        return None
    try:
        from orion_kmer_tpu_torch.utils import spans as recorder
    except ImportError:  # a port that keeps no spans
        return None
    taken = recorder.take()
    if taken.counts.get(recorder.DROPPED):
        card.err(f"spans: the recorder dropped {taken.counts[recorder.DROPPED]}: no span metric is read")
        return None
    lo_ns, hi_ns = ctx.window.start * 1e9, ctx.window.end * 1e9
    inside = [s for s in taken.spans if s.start_ns >= lo_ns and s.end_ns <= hi_ns]
    view = Spans(inside, ctx.trace.hi - ctx.window.end)
    roots = sorted(view.interval(s)[0] for s in view.named(ROOT))
    calls = sorted(c[0] for c in ctx.trace.calls)
    worst = max((abs(a - b) for a, b in zip(roots, calls)), default=None)
    if len(roots) != len(calls) or worst is None or worst > TOLERANCE_S:
        card.err(f"spans: {len(roots)} {ROOT} spans against {len(calls)} h100bench.call ranges, the starts "
                 f"{worst} s apart at most (limit {TOLERANCE_S} s): no span metric is read")
        return None
    card.err(f"spans: {len(inside)} in the window ({len(taken.spans)} taken), {len(roots)} calls, the {ROOT} "
             f"starts within {worst * 1e3:.4f} ms of the h100bench.call ranges; counts with no span open "
             f"{json.dumps(taken.counts)}")
    return view


def of(ctx) -> Spans | None:
    """The window's spans, taken from the port once a run (``ctx.memo``),
    or None where there are none or the clocks do not agree."""
    if "spans" not in ctx.memo:
        ctx.memo["spans"] = _mapped(ctx)
    return ctx.memo["spans"]


def seconds_a_call(ctx, name: str, own: bool = False) -> float | None:
    """The spans of ``name`` in the window, their summed duration (their
    self time with ``own``) over the completed calls: 0 where the window
    has none."""
    view = of(ctx)
    if view is None or not ctx.window.calls:
        return None
    return (view.self_s(name) if own else view.total_s(name)) / ctx.window.calls


def _idle_split(ctx) -> dict[str, float] | None:
    """The calls' device-idle seconds a call by the innermost span open on
    the CLI's thread, once a run; the split, each span's seconds a call
    and the share of the idle time under a span below ``cli.call`` go to
    standard error."""
    if "idle_split" in ctx.memo:
        return ctx.memo["idle_split"]
    view = of(ctx)
    split = None
    if view is not None and ctx.window.calls:
        calls = ctx.window.calls
        split = {n: t / calls for n, t in view.idle_by_span(ctx.trace.busy, ctx.trace.calls).items()}
        total = sum(split.values())
        named = 100.0 * (total - split[UNNAMED]) / total if total > 0 else None
        card.err(f"idle by span, s a call ({named} % under a span below {ROOT}): " + json.dumps(
            {n: t for n, t in sorted(split.items(), key=lambda x: -x[1])}))
        card.err("spans, s a call (total, self, number): " + json.dumps(
            {n: [view.total_s(n) / calls, view.self_s(n) / calls, len(view.named(n)) / calls]
             for n in sorted({s.name for s in view.spans})}))
    ctx.memo["idle_split"] = split
    return split


def idle_s_a_call(ctx, name: str) -> float | None:
    """The calls' device-idle seconds a call during which ``name`` was the
    innermost span open on the CLI's thread: 0 where none was."""
    split = _idle_split(ctx)
    return None if split is None else split.get(name, 0.0)
