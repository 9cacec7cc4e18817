"""``db.KmerDb.save`` of the cell's genome sets into the drained pipe,
until the drain has read it all: seconds, one save (~4 s)."""

import os

from h100bench.harness.readers import median_wall


def read(ctx):
    from orion_kmer_tpu_torch import engine
    from orion_kmer_tpu_torch.db import KmerDb

    k = ctx.traffic["k"]
    sets = ctx.memo.get("build_sets") or {
        os.path.basename(p): engine.unique_from_file(p, k, ctx.device) for p in ctx.inputs.genome_paths
    }
    db = KmerDb(k=k)
    for name, kmers in sets.items():
        db.add_reference(name, kmers)

    def save():
        db.save(ctx.job.db.path)
        if ctx.job.db.collect() is None:
            raise RuntimeError("the save wrote no stream")

    return median_wall(save, ctx.device, reps=1)
