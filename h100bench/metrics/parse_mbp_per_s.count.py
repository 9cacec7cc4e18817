"""The host stage alone (``host.stream_file_codes``: read, the parse on
the -t threads, the re-batching) over the cell's reads, drained with no
card work: Mbp parsed a second, median of three."""

from h100bench.harness.readers import median_wall


def read(ctx):
    from orion_kmer_tpu_torch import host

    k = ctx.traffic["k"]
    batch = host.batch_for(k, ctx.device)

    def parse():
        for _ in host.stream_file_codes(ctx.inputs.reads_path, k, True, batch):
            pass

    return ctx.inputs.bases / median_wall(parse, ctx.device) / 1e6
