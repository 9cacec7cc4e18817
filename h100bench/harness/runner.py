"""One run of one cell: inputs from the seed, a warm-up call, the window,
the metric readers, then the reference and the verdict."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

from . import card, digest, readers, trace, window
from .inputs import Workdir
from .manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]


def process_start() -> float:
    """The process's start on the ``time.monotonic`` clock, from
    ``/proc/self/stat`` (10 ms ticks); now where that cannot be read."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return now - age if 0 <= age < 3600 else now
    except (OSError, ValueError, IndexError):
        return now


def prepare_environment(root: Path) -> None:
    """The port at its defaults, with every build and kernel cache at a
    fixed path inside the checkout."""
    for key in [k for k in os.environ if k.startswith("ORION_KMER_")]:
        del os.environ[key]
    build = root / "build"
    os.environ["ORION_KMER_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def resolve(out):
    """A call's outputs with every digest computed."""
    if isinstance(out, dict):
        return {k: resolve(v) for k, v in out.items()}
    if isinstance(out, (digest.Pending, digest.DbDigest)):
        return out.result()
    return out


def prepare(man: Manifest, workload: str, seed: int, dev, workdir, pool, config_override: dict | None = None,
            log=card.log) -> SimpleNamespace:
    """What a run of ``workload`` reads: its configuration and traffic,
    the inputs made from ``seed`` and the command's job (``ctx.job``)."""
    cell = man.workload(workload)
    cfg = {**man.config(cell["config"]), **(config_override or {})}
    t = time.monotonic()
    inputs = man.generator(cfg["generator"]).make(cfg, seed, workdir, dev)
    readers.sync(dev)
    log(f"inputs: {cfg['generator']} of seed {seed} in {time.monotonic() - t:.3f} s")
    ctx = SimpleNamespace(
        manifest=man, cell=cell, config=cfg, traffic=man.traffic(cell["traffic"]), inputs=inputs, device=dev,
        workdir=workdir, pool=pool, buffers=digest.buffers(), memo={}, trace=None,
    )
    ctx.job = man.command(ctx.traffic["command"]).prepare(ctx)
    return ctx


def run(workload: str, seed: int, seconds: float, trace_on: bool, t_process: float,
        root: Path = ROOT, device: str = "cuda", config_override: dict | None = None,
        log=card.log) -> dict:
    """Run one cell once and return its result line as a dict (checks
    last).  ``device="cpu"`` skips the look for a card (tests only)."""
    man = Manifest(root)
    cell = man.workload(workload)
    import torch

    cuda = device == "cuda"
    if cuda:
        card.require_cards(cell["chips"])
        log(f"card: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible; "
            f"nvidia-smi: {card.power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device(device)
    from orion_kmer_tpu_torch import cli

    pool = ThreadPoolExecutor(2, thread_name_prefix="h100bench-hash")
    workdir = Workdir()
    ctx = None
    try:
        ctx = prepare(man, workload, seed, dev, workdir, pool, config_override, log)
        job = ctx.job
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        argv = ([] if cuda else ["--device", device]) + job.argv

        def call(argv=argv):
            rc = cli.main(argv)
            readers.sync(dev)
            if rc != 0:
                raise window.CallFailed(f"exit code {rc}")
            return job.collect()

        t = time.monotonic()
        warm = call(argv[: len(argv) - len(job.argv)] + job.warm_argv)
        log(f"warm-up: one call in {time.monotonic() - t:.3f} s")
        del warm
        setup_s = time.monotonic() - t_process
        ctx.counters_before = readers.launch_counters()
        # a cell whose end-to-end metrics read the device's timeline is
        # traced in every run
        profiled = trace_on or any(m["source"] == "device_trace" for m in man.metrics_of("end_to_end", workload))
        with trace.traced(profiled, cuda, workdir) as holder:
            if profiled:
                from torch.profiler import record_function

                with record_function(trace.WINDOW):
                    win = window.run(call, seconds, record_function, log)
            else:
                win = window.run(call, seconds, None, log)
        ctx.counters_after = readers.launch_counters()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        ctx.window, ctx.setup_s = win, setup_s
        log(f"window: {win.calls} calls in {win.elapsed:.3f} s, {win.cpu_s:.3f} CPU s, walls "
            f"{', '.join(f'{w:.3f}' for w in win.walls)}")
        dev_info = card.describe(cell["chips"]) if cuda else {"platform": "cpu", "kind": "cpu", "count": 1}
        dev_info["memory_peak_bytes"] = peak
        result = {"correct": False, "attempted": win.attempted, "failed": win.failed, "metrics": {}}
        if profiled:
            ctx.trace = holder.summary(log)
            s = ctx.trace
            log(f"busy share: union of device intervals {s.busy_s} s of a {s.window_s} s window "
                f"(idle {s.idle_pct} %); the intervals summed {s.summed_s} s")
        if trace_on:
            dev_info["busy_s"] = s.busy_s
            dev_info["window_s"] = s.window_s
        for m in man.metrics_of("per_layer" if trace_on else "end_to_end", workload):
            t = time.monotonic()
            value = man.metric_reader(m["name"]).read(ctx)
            log(f"metric {m['name']}: {value} {m['unit']} (read in {time.monotonic() - t:.3f} s)")
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"] = dev_info
        if trace_on:
            result["breakdown"] = {"device_ops": ctx.trace.device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
        ctx.trace = holder = None
        # the program's state freed before the reference runs
        ctx.memo.clear()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        outputs = [resolve(o) for o in win.outputs]
        t = time.monotonic()
        expected = job.expected()
        log(f"reference: {time.monotonic() - t:.3f} s; expected {json.dumps(expected, default=str)[:2000]}")
        checks = job.judge(outputs, expected) + [("failed_calls", win.failed, 0)]
        result["correct"] = bool(win.calls) and all(v <= lim for _, v, lim in checks)
        if outputs and not result["correct"]:
            log(f"first call's output: {json.dumps(outputs[0], default=str)[:2000]}")
        result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
        return result
    finally:
        if ctx is not None:
            ctx.job.close()
        pool.shutdown(wait=True)
        workdir.close()


def main(argv, t_process: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the port's H100 benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    prepare_environment(ROOT)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_process)
    except card.NoCard as e:
        card.err(f"h100bench: no card to run on: {e}")
        return 2
    bad = card.forbidden_loaded(list(sys.modules))
    if bad:
        card.err(f"h100bench: the run loaded modules it may not: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        card.err(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
