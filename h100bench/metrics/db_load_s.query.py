"""``db.KmerDb.load`` of the cell's database and the union of its sets
(``get_all_kmers_unified``): seconds, median of three."""

from h100bench.harness.readers import median_wall


def read(ctx):
    from orion_kmer_tpu_torch.db import KmerDb

    def load():
        ctx.memo["db_all"] = KmerDb.load(ctx.job.db_path).get_all_kmers_unified()

    return median_wall(load, ctx.device)
