"""What the metric readers of ``metrics/`` share: a host clock around a
public call of the port, the launch counters, and K1's roofline share."""

from __future__ import annotations

import statistics
import time

from . import peaks

KERNELS = {"K1": "extract", "K2": "merge", "K3": "compact", "K4": "sort"}


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def median_wall(fn, device, reps: int = 3) -> float:
    """The median host-clock wall of ``reps`` calls of ``fn``, each ended
    by a synchronisation of the device."""
    walls = []
    for _ in range(reps):
        sync(device)
        t0 = time.monotonic()
        fn()
        sync(device)
        walls.append(time.monotonic() - t0)
    return statistics.median(walls)


def launch_counters() -> dict[str, int]:
    """The port's launch counters of K1-K4 (``ops/<module>.launches``)."""
    import importlib

    return {k: importlib.import_module(f"orion_kmer_tpu_torch.ops.{m}").launches for k, m in KERNELS.items()}


def gbp(ctx) -> float:
    return ctx.inputs.bases / 1e9


def k1_roofline(ctx) -> float | None:
    """K1's share of its bandwidth bound over the traced window: the least
    bytes of the calls' inputs over the kernel's device time.  The time per
    launch is the trace's mean, times the launches the program counted,
    in case the profiler dropped records."""
    if ctx.trace is None:
        return None
    device_s, traced = ctx.trace.kernel_time("extract_kernel")
    launches = ctx.counters_after["K1"] - ctx.counters_before["K1"]
    if traced == 0 or launches == 0:
        return None
    k = ctx.traffic["k"]
    n_bytes = ctx.window.calls * peaks.k1_bytes(ctx.inputs.bases, ctx.inputs.valid_windows(k))
    return peaks.roofline_pct(n_bytes, device_s / traced * launches)


def idle_pct(ctx) -> float | None:
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.idle_pct
