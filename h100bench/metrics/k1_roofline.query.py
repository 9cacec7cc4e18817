"""K1's (``extract_kernel``) share of its bandwidth bound in the traced
window: each base read once at 2 bits and each valid window's 8-byte key
written once, at 3.35 TB/s, over K1's device time."""

from h100bench.harness.readers import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
