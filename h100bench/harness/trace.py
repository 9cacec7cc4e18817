"""The device's timeline in a traced window, from ``torch.profiler``.

The busy time is the length of the union of every kernel, copy and memset
interval: copies and kernels that overlap count once.  (The sum of
``self_device_time_total`` over ``key_averages()``, which earlier tools
read as the busy time, counts far more: 11.6-12.4 s where the union was
6.4-6.9 s, in 51 s windows of count-k31 on an H100.)  The window and each call are marked by
``record_function`` ranges of the benchmark's own, so the timeline is
clipped to the window and each idle gap is placed in its call.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time

WINDOW = "h100bench.window"
CALL = "h100bench.call"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The complement of sorted disjoint ``busy`` intervals in [lo, hi]."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces in brackets
    and argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()[:120]


class Summary:
    """What a traced window shows: seconds throughout."""

    def __init__(self, events):
        """``events``: the ``traceEvents`` of a Chrome trace that
        ``torch.profiler`` exported (``cat``, ``name``, ``ts`` and ``dur``
        in microseconds)."""
        device, cpu_ops = [], []
        window = None
        calls = []
        for e in events:
            kind, name = e.get("cat"), e.get("name", "")
            if e.get("ph") != "X" or kind is None:
                continue
            start = e["ts"] * 1e-6
            end = start + e.get("dur", 0) * 1e-6
            if kind in DEVICE_ACTIVITIES:
                device.append((start, end, name))
            elif name == WINDOW and kind == "user_annotation":
                window = (start, end)
            elif name == CALL and kind == "user_annotation":
                calls.append((start, end))
            elif kind == "cpu_op":
                cpu_ops.append((start, end, name))
        if window is None:
            raise RuntimeError("the profiler recorded no window range")
        self.lo, self.hi = window
        self.window_s = self.hi - self.lo
        self.device = [d for d in device if d[1] > self.lo and d[0] < self.hi]
        self.busy = union([(s, e) for s, e, _ in self.device], self.lo, self.hi)
        self.busy_s = sum(e - s for s, e in self.busy)
        self.idle_pct = 100.0 * (1.0 - self.busy_s / self.window_s)
        self.summed_s = sum(min(e, self.hi) - max(s, self.lo) for s, e, _ in self.device)
        self.calls = sorted(calls)
        self._cpu_ops = sorted(cpu_ops)
        self._cpu_starts = [c[0] for c in self._cpu_ops]

    def kernel_time(self, name_part: str) -> tuple[float, int]:
        """(summed device seconds, launches) of the kernels whose name
        holds ``name_part``."""
        hits = [e - s for s, e, n in self.device if name_part in n]
        return sum(hits), len(hits)

    def device_ops(self, top: int = 10) -> list[list]:
        by_name: dict[str, float] = {}
        for s, e, n in self.device:
            by_name[_short(n)] = by_name.get(_short(n), 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:top]]

    def _host_op(self, s: float, e: float) -> str:
        """The innermost torch op on the host that spans the gap's middle."""
        mid = (s + e) / 2
        i = bisect.bisect_right(self._cpu_starts, mid)
        best = None
        for j in range(i - 1, max(-1, i - 2000), -1):
            cs, ce, n = self._cpu_ops[j]
            if ce >= mid and (best is None or cs > best[0]):
                best = (cs, n)
                break
        return best[1] if best else "no torch op"

    def _where(self, s: float, e: float) -> str:
        mid = (s + e) / 2
        for cs, ce in self.calls:
            if cs <= mid < ce:
                first = bisect.bisect_left(self.busy, (cs,))
                inside = [b for b in self.busy[first:] if b[0] < ce]
                if not inside or e <= inside[0][0]:
                    return "call head"
                if s >= inside[-1][1]:
                    return "call tail"
                return "inside call"
        return "between calls"

    def idle_gaps(self, top: int = 10, look: int = 400) -> list[list]:
        """The idle time of the ``look`` longest gaps, summed by where in
        its call each falls and what the host was doing; the ``top``
        largest sums."""
        longest = sorted(gaps(self.busy, self.lo, self.hi), key=lambda g: g[0] - g[1])[:look]
        by_label: dict[str, float] = {}
        for s, e in longest:
            label = f"{self._where(s, e)}: {self._host_op(s, e)}"
            by_label[label] = by_label.get(label, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by_label.items(), key=lambda x: -x[1])[:top]]


@contextlib.contextmanager
def traced(enabled: bool, cuda: bool, workdir):
    """Run the block under ``torch.profiler`` (CPU and, on a card, CUDA
    activity) when ``enabled``; yields a holder whose ``summary()`` reads
    the timeline afterwards, from the Chrome trace exported into
    ``workdir`` (the format holds across torch versions)."""

    class Holder:
        prof = None

        def summary(self, log=print) -> Summary:
            t = time.monotonic()
            path = str(workdir / "trace.json")
            self.prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            os.unlink(path)
            log(f"trace: {len(events)} events, {size} bytes, exported and read in {time.monotonic() - t:.3f} s")
            return Summary(events)

    holder = Holder()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        holder.prof = prof
        yield holder
