"""``engine.query_lines`` alone (the streamed parse, K1, the sort, K2's
join, the hits, the passing ids), with the database already unified:
seconds per Gbp of reads, median of three."""

from h100bench.harness.readers import gbp, median_wall


def read(ctx):
    from orion_kmer_tpu_torch import engine
    from orion_kmer_tpu_torch.db import KmerDb

    if "db_all" not in ctx.memo:
        ctx.memo["db_all"] = KmerDb.load(ctx.job.db_path).get_all_kmers_unified()
    db_all = ctx.memo["db_all"]

    def join():
        engine.query_lines(db_all, ctx.inputs.reads_path, ctx.traffic["k"], ctx.traffic["min_hits"], ctx.device)

    return median_wall(join, ctx.device) / gbp(ctx)
