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
- count: ``engine.count_file`` on the card under a CPU ``torch.profiler``
  (on both sides of a comparison), wall, and the time its consumer
  waited for the next staged batch, the port's ``engine.wait`` spans
  (``utils/spans.py``; None for a checkout without them), where a card
  is visible;
- query: ``chip_smoke.query_split`` on the card, `query -c 10` of the
  reads against the DB of ``chip_smoke.py`` phase 6 (its three
  references): the parse of the raw reads, the parse and the cut, the
  whole host stage to the card, ``engine.query_file`` with its consumer's
  waits, and the device time (a checkout without the staged query: the
  parse, the wall and the device time).

Then, on the card, the tail of `count -m 2 --histogram` after
``count_file`` (one `tail` line):

- fetch: the table's copy from the card to the host, each way three
  times in turns, with torch's cache of pinned host memory emptied
  before each (a fresh CLI process has none): ``pageable``, the
  parent's ``u64_from_keys`` and ``.cpu()``; ``pinned``, the sign flip
  on the card and both planes into one pinned destination each;
  ``ring``, the same through a ring of four 16 MB pinned chunks with the
  host's copy of chunk i out of the ring beside the card's copy of the
  next; ``fetch_table``, the checkout's ``engine.fetch_table`` where it
  has one;
- the rest of the tail as the checkout's `count` runs it: a checkout
  with ``native.render_counts`` writes the TSV and the histogram in one
  pass (``write_s``), timed at -t 1, 4 and 8 with the pass alone
  (``fused_s``) and the histogram's lines; an older one times its
  histogram (``np.unique``), its min-count filter and its TSV;
- the in-process CLI `count -k 31 -m 2 --histogram` of the reads, twice.

A checkout from before the parser threads parses serially whatever T
is.  Prints the host's core counts, then one JSON line per T,
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


SIGN = -(1 << 63)
RING_CHUNK, RING_SLOTS = 1 << 21, 4  # int64 elements a chunk: 16 MB


def fetch_pageable(torch, np, keys, counts):
    """The parent's fetch: ``u64_from_keys`` (``.cpu()``, then the sign
    flip on the host) and ``counts.cpu()``."""
    return keys.cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63), counts.cpu().numpy()


def fetch_pinned(torch, np, keys, counts):
    """The sign flipped on the card, both planes copied at once into one
    pinned destination each, one synchronisation."""
    hk = torch.empty(keys.shape, dtype=torch.int64, pin_memory=True)
    hc = torch.empty(counts.shape, dtype=torch.int64, pin_memory=True)
    hk.copy_(keys ^ SIGN, non_blocking=True)
    hc.copy_(counts, non_blocking=True)
    torch.cuda.current_stream().synchronize()
    return hk.numpy().view(np.uint64), hc.numpy()


def fetch_ring(torch, np, native, keys, counts):
    """The sign flipped on the card, both planes copied chunk by chunk
    through a ring of RING_SLOTS pinned chunks into fresh (hugepage-advised)
    host arrays: the host copies chunk i out of the ring while the card
    copies the next ones in."""
    n = keys.shape[0]
    flipped = keys ^ SIGN
    out_k, out_c = np.empty(n, np.int64), np.empty(n, np.int64)
    native._advise_hugepages(out_k)
    native._advise_hugepages(out_c)
    pieces = [(src, dst, lo, min(lo + RING_CHUNK, n)) for src, dst in ((flipped, out_k), (counts, out_c))
              for lo in range(0, n, RING_CHUNK)]
    ring = [torch.empty(RING_CHUNK, dtype=torch.int64, pin_memory=True) for _ in range(RING_SLOTS)]
    done = [torch.cuda.Event() for _ in range(RING_SLOTS)]

    def issue(i):
        src, _, lo, hi = pieces[i]
        ring[i % RING_SLOTS][: hi - lo].copy_(src[lo:hi], non_blocking=True)
        done[i % RING_SLOTS].record()

    for i in range(min(RING_SLOTS, len(pieces))):
        issue(i)
    for i, (_, dst, lo, hi) in enumerate(pieces):
        done[i % RING_SLOTS].synchronize()
        np.copyto(dst[lo:hi], ring[i % RING_SLOTS][: hi - lo].numpy())
        if i + RING_SLOTS < len(pieces):
            issue(i + RING_SLOTS)
    return out_k.view(np.uint64), out_c


def tail_split(np, torch, engine, native, fq, work) -> dict:
    """The tail of `count -m 2 --histogram` after its table (see the
    module's docstring)."""
    import gc

    from orion_kmer_tpu_torch import cli
    from orion_kmer_tpu_torch.commands import count as count_cmd
    from orion_kmer_tpu_torch.keys import keys_from_u64

    vals, counts = engine.count_file(fq, 31, "cuda")
    keys, cnt = keys_from_u64(vals).cuda(), torch.from_numpy(counts).cuda()
    # torch's cache of pinned host memory: emptied before each fetch where
    # this torch can (the name moved between versions)
    empty_host_cache = (getattr(torch._C, "_host_emptyCache", None)
                        or getattr(torch._C, "_accelerator_emptyHostCache", None))
    ways = {"pageable": lambda: fetch_pageable(torch, np, keys, cnt),
            "pinned": lambda: fetch_pinned(torch, np, keys, cnt),
            "ring": lambda: fetch_ring(torch, np, native, keys, cnt)}
    if hasattr(engine, "fetch_table"):
        ways["fetch_table"] = lambda: engine.fetch_table(keys, cnt)
    tail = {"rows": int(vals.shape[0]), "host_cache_emptied": empty_host_cache is not None,
            "fetch_s": {name: [] for name in ways}}
    for _ in range(3):
        for name, fetch in ways.items():
            gc.collect()
            if empty_host_cache is not None:
                empty_host_cache()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            got = fetch()
            tail["fetch_s"][name].append(time.monotonic() - t0)
            assert np.array_equal(got[0], vals) and np.array_equal(got[1], counts), name
            del got
    del keys, cnt
    if hasattr(native, "render_counts"):
        tail["threads"] = {}
        for t in (1, 4, 8):
            os.environ["ORION_KMER_THREADS"] = str(t)
            row = {}
            t0 = time.monotonic()
            hist = native.render_counts(lambda b: None, vals, counts, 31, 2, True, t)
            row["fused_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            with open(work / "tail_lines.hist", "w") as f:
                count_cmd._write_histogram_rows(f, *hist)
            row["histogram_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            count_cmd.write_counts_tsv(work / "tail.tsv", vals, counts, 31, 2, work / "tail.hist")
            row["write_s"] = time.monotonic() - t0
            tail["threads"][t] = row
    else:
        t0 = time.monotonic()
        count_cmd.write_histogram(work / "tail.hist", counts)
        tail["histogram_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        keep = counts >= 2
        kept_vals, kept_counts = vals[keep], counts[keep]
        tail["filter_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        count_cmd.write_counts_tsv(work / "tail.tsv", kept_vals, kept_counts, 31)
        tail["tsv_s"] = time.monotonic() - t0
        tail["tsv_lines"] = int(kept_vals.shape[0])
    tail["cli_s"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(["count", "-k", "31", "-m", "2", "--histogram", str(work / "cli.hist"),
                       "-i", str(fq), "-o", str(work / "cli.tsv")])
        torch.cuda.synchronize()
        tail["cli_s"].append(time.monotonic() - t0)
        assert rc == 0
    return tail


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
    try:
        from orion_kmer_tpu_torch.utils import spans
    except ImportError:  # a checkout from before the port's spans
        spans = None

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
            if spans is not None:
                spans.take()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                t0 = time.monotonic()
                engine.count_file(fq, 31, "cuda")
                torch.cuda.synchronize()
                row["count_file_s"] = time.monotonic() - t0
            row["count_file_wait_s"] = None if spans is None else 1e-9 * sum(
                s.end_ns - s.start_ns for s in spans.take().spans if s.name == "engine.wait")
            row["query"] = chip_smoke.query_split(torch, engine, host, fq, db_vals, 31, torch.device("cuda"))
        print(json.dumps(row), flush=True)
    if cuda:
        print(json.dumps({"tail": tail_split(np, torch, engine, native, fq, work)}), flush=True)
    print(json.dumps({"peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
