"""The measured window: whole CLI calls, back to back, on the same inputs."""

from __future__ import annotations

import contextlib
import os
import time


class CallFailed(RuntimeError):
    pass


class Window:
    def __init__(self, start: float, end: float, outputs: list, walls: list[float], failed: int,
                 cpu_s: float = 0.0):
        self.start = start
        self.end = end
        self.elapsed = end - start
        self.cpu_s = cpu_s
        self.outputs = outputs
        self.walls = walls
        self.calls = len(outputs)
        self.attempted = len(outputs) + failed
        self.failed = failed

    def rate(self, work_per_call: float) -> float | None:
        """All the work of the completed calls over the time from the
        window's start to the end of the last call."""
        if not self.calls:
            return None
        return work_per_call * self.calls / self.elapsed


def cpu_seconds() -> float:
    """The process's CPU time, user and system, over all its threads."""
    t = os.times()
    return t.user + t.system


def run(call, seconds: float, annotate=None, log=print) -> Window:
    """Call ``call()`` until a call would start after ``seconds``: the
    window ends when the last call that started before the deadline
    finishes.  A failed call ends the window.  Besides the wall, the
    window keeps the CPU time the process spent in it (``cpu_s``)."""
    annotate = annotate or (lambda name: contextlib.nullcontext())
    outputs, walls, failed = [], [], 0
    cpu0 = cpu_seconds()
    start = time.monotonic()
    deadline = start + seconds
    while True:
        t0 = time.monotonic()
        if t0 >= deadline:
            break
        try:
            with annotate("h100bench.call"):
                out = call()
        except CallFailed as e:
            log(f"window: call {len(outputs)} failed: {e}")
            failed += 1
            break
        walls.append(time.monotonic() - t0)
        outputs.append(out)
    end = time.monotonic()
    return Window(start, end, outputs, walls, failed, cpu_seconds() - cpu0)
