"""K2's (``merge_kernel``) share of its bandwidth bound in the traced
window: the least bytes of its launches as the port counts them
(``k2.bytes``: 16 B a key, 32 with a payload, 33 in the fold), at
3.35 TB/s, over K2's device time.  The time per launch is the trace's
mean, times the launches the program counted, as for K1."""

from h100bench.harness import peaks, spans


def read(ctx):
    view = spans.of(ctx)
    if view is None:
        return None
    n_bytes = view.count("k2.bytes")
    device_s, traced = ctx.trace.kernel_time("merge_kernel")
    launches = ctx.counters_after["K2"] - ctx.counters_before["K2"]
    if not n_bytes or traced == 0 or launches == 0:
        return None
    return peaks.roofline_pct(n_bytes, device_s / traced * launches)
