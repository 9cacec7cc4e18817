"""``engine.count_file`` alone (staging, the count table, the fetch),
without the CLI's tail: seconds per Gbp of reads, median of three."""

from h100bench.harness.readers import gbp, median_wall


def read(ctx):
    from orion_kmer_tpu_torch import engine

    def count():
        ctx.memo["count_table"] = engine.count_file(ctx.inputs.reads_path, ctx.traffic["k"], ctx.device)

    return median_wall(count, ctx.device) / gbp(ctx)
