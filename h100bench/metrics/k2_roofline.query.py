"""K2's (``merge_kernel``) share of its bandwidth bound in the traced
window, read as ``k2_roofline.count`` reads it: in ``query`` each launch is
the join of the database's keys with a batch's tagged queries (32 B a key
in ``k2.bytes``)."""

from pathlib import Path

from h100bench.harness.manifest import load_module

read = load_module(Path(__file__).with_name("k2_roofline.count.py"), "metric").read
