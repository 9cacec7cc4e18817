#!/usr/bin/env python3
"""What the port's span recorder (``orion_kmer_tpu_torch/utils/spans.py``)
costs, on a machine with a CUDA card.

    python3 tools/torch_span_cost.py [--workloads count-k31,build-k31] [--calls 4] [--seed N]

- off: the nanoseconds of one ``with span(...)`` and of one ``count()``
  while nothing records, the mean over 10^6 calls each;
- on: for each cell of ``h100bench/`` at its configured size, the cell's
  CLI call under ``torch.profiler`` (CPU and CUDA activity, as a traced
  window of the benchmark runs it), ``--calls`` times with the recorder
  on and as many with it forced off, in turns (on, off, off, on, ...).
  The program has no switch: this script forces it off by replacing
  ``spans.recording``.  Each call's wall and the process's CPU seconds
  (user and system, all threads), and the spans a call kept.

Prints the card and one JSON line for the off cost, then one a cell, with
each side's calls and medians.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from h100bench.harness import card, readers, runner, window  # noqa: E402
from h100bench.harness.inputs import Workdir  # noqa: E402
from h100bench.harness.manifest import Manifest  # noqa: E402


def off_cost(spans, n: int = 10**6) -> dict:
    """ns per ``with span()`` and per ``count()`` while nothing records."""
    assert not spans.recording()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with spans.span("engine.wait"):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(n):
        spans.count("k2.bytes", 16)
    t2 = time.perf_counter_ns()
    return {"span_ns": (t1 - t0) / n, "count_ns": (t2 - t1) / n}


def cell_cost(workload: str, seed: int, calls: int, spans, device: str = "cuda",
              config_override: dict | None = None) -> dict:
    """The on and off sides of one cell (``device="cpu"`` and a small
    ``config_override`` rehearse the script without a card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orion_kmer_tpu_torch import cli

    dev = torch.device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    argv = [] if dev.type == "cuda" else ["--device", "cpu"]
    workdir = Workdir()
    ctx = None
    recording = spans.recording
    try:
        with ThreadPoolExecutor(2) as pool:
            ctx = runner.prepare(Manifest(ROOT), workload, seed, dev, workdir, pool, config_override,
                                 log=lambda msg: None)

            def call():
                if cli.main(argv + ctx.job.argv) != 0:
                    raise window.CallFailed(workload)
                readers.sync(dev)
                runner.resolve(ctx.job.collect())

            call()  # warm-up
            sides = {"on": [], "off": []}
            order = ["on", "off", "off", "on"] * ((calls + 1) // 2)
            for side in order[: 2 * calls]:
                spans.recording = recording if side == "on" else (lambda: False)
                spans.take()
                with profile(activities=activities):
                    cpu0, t0 = window.cpu_seconds(), time.monotonic()
                    call()
                    wall, cpu = time.monotonic() - t0, window.cpu_seconds() - cpu0
                sides[side].append({"wall_s": wall, "cpu_s": cpu, "spans": len(spans.take().spans)})
    finally:
        spans.recording = recording
        if ctx is not None:
            ctx.job.close()
        workdir.close()
    out = {"workload": workload, "seed": seed}
    for side, rows in sides.items():
        out[side] = {"calls": rows, **{f"median_{k}": statistics.median(r[k] for r in rows)
                                       for k in ("wall_s", "cpu_s", "spans")}}
    out["cpu_on_over_off"] = out["on"]["median_cpu_s"] / out["off"]["median_cpu_s"]
    out["wall_on_over_off"] = out["on"]["median_wall_s"] / out["off"]["median_wall_s"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", default="count-k31,build-k31")
    ap.add_argument("--calls", type=int, default=4, help="calls a side")
    ap.add_argument("--seed", type=int, default=2600000001)
    args = ap.parse_args()
    runner.prepare_environment(ROOT)
    card.require_cards(1)
    from orion_kmer_tpu_torch.utils import spans

    print(json.dumps({"card": card.power_limit()}), flush=True)
    print(json.dumps({"off": off_cost(spans)}), flush=True)
    for w in args.workloads.split(","):
        print(json.dumps(cell_cost(w, args.seed, args.calls, spans)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
