#!/usr/bin/env python3
"""Rate of the port's host ingest stage at several parser-thread counts.

    python3 tools/torch_ingest_rate.py [--root DIR] [--gbp G] [--threads 1,2,4,8,16] [--seed N]

Makes the E. coli-like reads of ``chip_smoke.py`` phase 5 once, then, for
each thread count T, set as ``ORION_KMER_THREADS`` the way ``-t`` sets it
(parser threads: at most ``host.MAX_PARSE_THREADS``), with the host code
of the checkout at ``--root`` (default: this one):

- read (once, not per T): the file read in chunks into one buffer;
- parse: ``host.native_chunks`` drained (read, parse, the pieces checked
  and ordered; a checkout without it: ``host.stream_native_chunks``),
  positions/s, with the native parse calls' count, their summed and mean
  duration, and their mean concurrency (summed duration over the wall);
- host: ``host.stream_file_batches`` with every batch wire-packed
  (``pack_for_transfer``): everything ``count`` does before the device,
  positions/s;
- stage: ``engine.staged_batches`` drained on the card (the host stage
  and the copies, no device work), where a card is visible;
- count: ``engine.count_file`` on the card, wall, and the time its
  consumer waited for the next staged batch, where a card is visible;
- query: ``chip_smoke.query_split`` on the card, `query -c 10` of the
  reads against the DB of ``chip_smoke.py`` phase 6 (its three
  references): the parse of the raw reads, the parse and the cut, the
  whole host stage to the card, ``engine.query_file`` with its consumer's
  waits, and the device time (a checkout without the staged query: the
  parse, the wall and the device time).

Then, on the card, the tail of `count -m 2 --histogram` after
``count_file``: the histogram, the min-count filter and the TSV, each
timed.  A checkout from before the parser threads parses serially
whatever T is.  Prints the host's core counts, then one JSON line per T,
then the peak RSS of the process.  Run the parent and the change in one
call, each as its own process, to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose orion_kmer_tpu_torch is measured")
    ap.add_argument("--gbp", type=float, default=0.5)
    ap.add_argument("--threads", default="1,2,4,8,16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke  # this checkout's, whichever root is measured

    sys.path.insert(0, str(root))
    import numpy as np

    from orion_kmer_tpu_torch import codec, host
    from orion_kmer_tpu_torch.ingest import native

    assert Path(host.__file__).resolve().is_relative_to(root), host.__file__
    assert native.available()  # builds the parser before anything is timed
    work = HERE / "build" / "ingest_rate"
    work.mkdir(parents=True, exist_ok=True)
    fq = work / f"reads_{args.gbp}_{args.seed}.fastq"
    db_path = fq.with_suffix(".db.npy")  # the DB's sorted unique 31-mers
    if not (fq.exists() and db_path.exists()):
        rng = np.random.default_rng(args.seed)
        _, _, genome, _ = chip_smoke.write_reads_fastq(np, fq, rng, args.gbp)
        refs = chip_smoke.write_references(np, work, rng, genome)
        kmers = np.concatenate([codec.extract_kmers_np(g, 31) for _, g in refs.values()])
        np.save(db_path, chip_smoke.sorted_unique(np, kmers))
    db_vals = np.load(db_path)
    print(json.dumps({"root": str(root), "bytes": fq.stat().st_size, "os.cpu_count": os.cpu_count(),
                      "sched_getaffinity": len(os.sched_getaffinity(0)),
                      "max_parse_threads": getattr(host, "MAX_PARSE_THREADS", None)}), flush=True)
    cuda = False
    try:
        import torch

        cuda = torch.cuda.is_available()
        if cuda:
            from orion_kmer_tpu_torch import engine

            print(json.dumps({"card": chip_smoke.gpu_name_and_limit()}), flush=True)
            engine.count_file(fq, 31, "cuda")  # warm-up: kernel build and load, the CUDA context
            engine.query_file(db_vals, fq, 31, 10, "cuda")
    except ImportError:
        pass
    chunk = getattr(host, "CHUNK_BYTES", 64 << 20)
    buf = bytearray(chunk)
    t0 = time.monotonic()
    with open(fq, "rb") as f:
        while f.readinto(buf):
            pass
    print(json.dumps({"read_s": time.monotonic() - t0, "chunk_bytes": chunk}), flush=True)
    calls = []
    name = "parse_fastx_raw" if hasattr(native, "parse_fastx_raw") else "parse_fastx_chunk"
    real = getattr(native, name)

    def timed(*a, **kw):
        t0 = time.monotonic()
        out = real(*a, **kw)
        calls.append(time.monotonic() - t0)
        return out

    setattr(native, name, timed)
    waits = []
    if cuda:
        real_prefetch = engine._prefetch

        def waited(iterator, depth=None):
            it = real_prefetch(iterator, depth)
            while True:
                t0 = time.monotonic()
                item = next(it, None)
                waits.append(time.monotonic() - t0)
                if item is None:
                    return
                yield item

    for t in [int(x) for x in args.threads.split(",")]:
        os.environ["ORION_KMER_THREADS"] = str(t)
        row = {"threads": t}
        calls.clear()
        t0 = time.monotonic()
        if hasattr(host, "native_chunks"):  # the chunks as the count path takes them: no id lists
            positions = sum(c.codes.shape[0] for c in host.native_chunks(fq, 31))
        else:
            positions = sum(c[0].shape[0] for c in host.stream_native_chunks(fq, 31))
        row["parse_s"] = time.monotonic() - t0
        row["parse_M_per_s"] = positions / row["parse_s"] / 1e6
        row["parse_calls"] = len(calls)
        row["parse_busy_s"] = sum(calls)
        row["parse_mean_call_s"] = sum(calls) / max(1, len(calls))
        row["parse_concurrency"] = sum(calls) / row["parse_s"]
        t0 = time.monotonic()
        positions = 0
        for pb in host.stream_file_batches(fq, 31, batch_positions=1 << 24):
            host.pack_for_transfer(pb.codes, host._bucket(pb.codes.shape[0]))
            positions += pb.codes.shape[0]
        row["host_s"] = time.monotonic() - t0
        row["host_M_per_s"] = positions / row["host_s"] / 1e6
        if cuda:
            t0 = time.monotonic()
            for _ in engine.staged_batches(fq, 31, True, 1 << 24, torch.device("cuda")):
                pass
            torch.cuda.synchronize()
            row["stage_s"] = time.monotonic() - t0
            waits.clear()
            engine._prefetch = waited
            t0 = time.monotonic()
            engine.count_file(fq, 31, "cuda")
            torch.cuda.synchronize()
            row["count_file_s"] = time.monotonic() - t0
            engine._prefetch = real_prefetch
            row["count_file_wait_s"] = sum(waits)
            row["query"] = chip_smoke.query_split(torch, engine, host, fq, db_vals, 31, torch.device("cuda"))
        print(json.dumps(row), flush=True)
    if cuda:
        # the tail of `count -m 2 --histogram` after count_file: histogram, filter, TSV
        from orion_kmer_tpu_torch.commands import count as count_cmd

        vals, counts = engine.count_file(fq, 31, "cuda")
        tail = {}
        t0 = time.monotonic()
        count_cmd.write_histogram(work / "tail.hist", counts)
        tail["histogram_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        keep = counts >= 2
        vals, counts = vals[keep], counts[keep]
        tail["filter_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        count_cmd.write_counts_tsv(work / "tail.tsv", vals, counts, 31)
        tail["tsv_s"] = time.monotonic() - t0
        tail["tsv_lines"] = int(vals.shape[0])
        print(json.dumps(tail), flush=True)
    print(json.dumps({"peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
