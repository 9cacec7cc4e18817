"""``engine.unique_from_file`` over each genome of the cell, one after
another: the mean wall per genome, in ms."""

import os
import time

from h100bench.harness.readers import sync


def read(ctx):
    from orion_kmer_tpu_torch import engine

    paths = ctx.inputs.genome_paths
    sets = {}
    sync(ctx.device)
    t0 = time.monotonic()
    for p in paths:
        sets[os.path.basename(p)] = engine.unique_from_file(p, ctx.traffic["k"], ctx.device)
    sync(ctx.device)
    wall = time.monotonic() - t0
    ctx.memo["build_sets"] = sets
    return 1000 * wall / len(paths)
