"""Progress / resource tracking + logging.

Equivalent of the reference's sole observability mechanism,
``track_progress_and_resources`` (utils.rs:62-112): wraps a task closure,
draws a progress bar on stderr, and logs wall-time + max RSS when done.
Verbosity mapping mirrors mod.rs:12-17 (0=WARN 1=INFO 2=DEBUG 3+=TRACE).
"""

from __future__ import annotations

import logging
import resource
import sys
import time

logger = logging.getLogger("orion_kmer_tpu_torch")


def get_num_threads(cli_threads: int) -> int:
    """0 means all logical cores (utils.rs:17-25)."""
    import os

    n = (os.cpu_count() or 1) if cli_threads == 0 else cli_threads
    logger.debug("Using %d threads for processing.", n)
    return n


def worker_threads(default: int | None = None) -> int:
    """The resolved host worker-thread count for this process.

    The CLI exports -t via ORION_KMER_THREADS (cli.py; utils.rs:28-33
    semantics -- the rayon pool analog); library users without the env
    var get ``default`` (or all logical cores).  Consumed by the ingest
    prefetch queue (host._prefetch)."""
    import os

    v = os.environ.get("ORION_KMER_THREADS")
    if v is not None and v.isdigit() and int(v) > 0:
        return int(v)
    if default is not None:
        return default
    return os.cpu_count() or 1

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def setup_logging(verbose: int) -> None:
    level = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}.get(verbose, TRACE)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s")
    )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)


class ProgressBar:
    """Minimal indicatif-style bar (template utils.rs:74-84).

    Renders to stderr only when it is a TTY; message/position tracking is
    always maintained so callers can use it unconditionally.
    """

    def __init__(self, total: int, desc: str = ""):
        self.total = total
        self.desc = desc
        self.pos = 0
        self.message = ""
        self._start = time.monotonic()
        self._render_enabled = sys.stderr.isatty()

    def set_message(self, msg: str) -> None:
        self.message = msg
        self._render()

    def inc(self, n: int = 1) -> None:
        self.pos += n
        self._render()

    def _render(self) -> None:
        if not self._render_enabled:
            return
        elapsed = time.monotonic() - self._start
        if self.total:
            frac = min(self.pos / self.total, 1.0)
            bar = ("#" * int(frac * 40)).ljust(40, "-")
            sys.stderr.write(
                f"\r[{elapsed:7.1f}s] [{bar}] {self.pos}/{self.total} {self.message}"
            )
        else:
            sys.stderr.write(f"\r[{elapsed:7.1f}s] {self.message}")
        sys.stderr.flush()

    def finish(self, msg: str) -> None:
        if self._render_enabled:
            sys.stderr.write("\n")
        self.message = msg


def max_rss_mb() -> float:
    """Peak RSS of this process in MB (psutil equivalent, utils.rs:93-109)."""
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KB on Linux
    return kb / 1024.0


def track_progress_and_resources(task_description: str, total_items: int, func):
    """Run ``func(progress_bar)``; log wall time and max RSS (utils.rs:62-112)."""
    logger.info("Starting task: %s", task_description)
    start = time.monotonic()
    pb = ProgressBar(total_items, task_description)
    try:
        result = func(pb)
    finally:
        pb.finish(f"{task_description} completed.")
        duration = time.monotonic() - start
        logger.info("Task '%s' finished in %.2fs", task_description, duration)
        logger.info(
            "Max RAM usage for task '%s': %d MB", task_description, int(max_rss_mb())
        )
    return result
