"""The tail of ``count`` alone (``commands.count.write_counts_tsv``: the
-m filter, the histogram and the TSV) on ``count_file``'s result, into
the drained pipe, until the drain has read it all: seconds per Gbp,
median of three."""

from h100bench.harness.readers import gbp, median_wall


def read(ctx):
    from orion_kmer_tpu_torch import engine
    from orion_kmer_tpu_torch.commands.count import write_counts_tsv

    t = ctx.traffic
    if "count_table" not in ctx.memo:
        ctx.memo["count_table"] = engine.count_file(ctx.inputs.reads_path, t["k"], ctx.device)
    vals, counts = ctx.memo["count_table"]
    hist = ctx.workdir / "probe-histogram.txt" if t["histogram"] else None

    def tail():
        write_counts_tsv(ctx.job.tsv.path, vals, counts, t["k"], t["min_count"], hist)
        if ctx.job.tsv.collect() is None:
            raise RuntimeError("the tail wrote no stream")

    return median_wall(tail, ctx.device) / gbp(ctx)
