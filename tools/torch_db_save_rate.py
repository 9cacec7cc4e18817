#!/usr/bin/env python3
"""Time a k-mer database's write into a drained pipe, and a build's peak
host memory, for one or more checkouts taking turns.

    python3 tools/torch_db_save_rate.py [--roots build/parent,.] [--sets 50] [--keys 5000000]
                                        [--reps 3] [--seed N] [--build-genomes 50] [--device cuda]

Each rep of each root runs in a fresh process that imports that root's
``orion_kmer_tpu_torch``.  It makes ``--sets`` sorted unique sets of
``--keys`` 62-bit values (random gaps, so no sort), puts them in a
``KmerDb`` as they are, and times with the host clock, into a named pipe
drained and digested as ``h100bench`` drains build-k31's database
(``harness.digest.PipeSink``, ``consume_bincode_db``, two hash threads):

- ``save_s``: ``KmerDb.save`` into the pipe, until the drain has digested
  it (``save_gb_per_s``); ``save_rss_bytes``: the process's peak RSS
  grown over the save;
- ``bincode_s``: ``to_bincode()`` alone;
- ``prebuilt_s``: those bytes written into the pipe in one ``write``,
  until digested: the drain's own rate (``drain_gb_per_s``).

With ``--build-genomes G`` it also makes ``h100bench``'s
``bacteria-50x5mbp`` genomes from the seed (the first G), and runs
``python3 -m orion_kmer_tpu_torch --device D build -k 31 -g ... -o
/dev/null`` once a rep under each root, in turns, as a fresh process:
its wall and its peak RSS (``os.wait4``).

Prints one JSON line a measurement and a summary line with each root's
medians, the card's name and power limit, and the host's CPU model.
``--device cpu`` with small sizes rehearses it on a machine without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _one(args) -> dict:
    """One rep under ``args.one``'s checkout, in this process."""
    sys.path.insert(0, str(Path(args.one).resolve()))
    import resource
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from h100bench.harness import digest
    from orion_kmer_tpu_torch.db import KmerDb

    rng = np.random.default_rng(args.seed)
    gap = (1 << 62) // args.keys
    refs = {f"g{i}.fa": np.cumsum(rng.integers(1, gap, args.keys, dtype=np.uint64)) for i in range(args.sets)}
    db = KmerDb(k=31, references=refs)

    def rss() -> int:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    out = {"root": args.one, "pid": os.getpid()}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        sink = digest.PipeSink(Path(tmp) / "kmers.db", digest.consume_bincode_db, pool, digest.buffers())

        def drained(write) -> float:
            t0 = time.perf_counter()
            write()
            got = sink.collect()
            if got is None:
                raise RuntimeError("the drain read no stream")
            result = got.result()
            seconds = time.perf_counter() - t0
            if len(result["refs"]) != args.sets:
                raise RuntimeError("the drain read a short database")
            return seconds

        try:
            before = rss()
            out["save_s"] = drained(lambda: db.save(sink.path))
            out["save_rss_bytes"] = rss() - before
            t0 = time.perf_counter()
            data = db.to_bincode()
            out["bincode_s"] = time.perf_counter() - t0
            out["bytes"] = len(data)

            def write_prebuilt():
                with open(sink.path, "wb") as f:
                    f.write(data)

            out["prebuilt_s"] = drained(write_prebuilt)
        finally:
            sink.close()
    out["save_gb_per_s"] = out["bytes"] / out["save_s"] / 1e9
    out["drain_gb_per_s"] = out["bytes"] / out["prebuilt_s"] / 1e9
    return out


def _genomes(args, workdir: Path) -> list[str]:
    sys.path.insert(0, str(ROOT))
    import torch

    from h100bench.generators import clades

    cfg = json.loads((ROOT / "h100bench/configs/bacteria-50x5mbp.json").read_text())
    inputs = clades.make(cfg, args.seed, workdir, torch.device(args.device))
    return [str(p) for p in inputs.genome_paths[: args.build_genomes]]


def _build(root: str, genomes: list[str], device: str) -> dict:
    argv = [sys.executable, "-m", "orion_kmer_tpu_torch", "--device", device, "build", "-k", "31",
            "-g", *genomes, "-o", "/dev/null"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    err = proc.stderr.read()
    _, status, usage = os.wait4(proc.pid, 0)
    wall = time.perf_counter() - t0
    if os.waitstatus_to_exitcode(status) != 0:
        raise RuntimeError(f"build under {root} failed: {err.decode()[-2000:]}")
    return {"root": root, "build_wall_s": wall, "build_peak_rss_bytes": usage.ru_maxrss * 1024}


def _machine(device: str) -> dict:
    out = {}
    first = Path("/proc/cpuinfo").read_text().split("\n\n", 1)[0]
    fields = dict(ln.split(":", 1) for ln in first.splitlines() if ":" in ln)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    # where the model name reads "unknown", the vendor, family and model still say which CPU
    out["host_cpu"] = " / ".join(fields.get(k, "?") for k in ("model name", "vendor_id", "cpu family", "model"))
    out["host_cores"] = os.cpu_count()
    if device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True)
        out["card"] = smi.stdout.strip()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=".")
    ap.add_argument("--sets", type=int, default=50)
    ap.add_argument("--keys", type=int, default=5_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--build-genomes", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(_one(args)))
        return 0
    roots = args.roots.split(",")
    rows: list[dict] = []
    for rep in range(args.reps):
        for root in roots if rep % 2 == 0 else roots[::-1]:
            got = subprocess.run([sys.executable, __file__, "--one", root, "--sets", str(args.sets),
                                  "--keys", str(args.keys), "--seed", str(args.seed + rep)],
                                 capture_output=True, text=True, cwd=ROOT)
            if got.returncode != 0:
                print(got.stderr[-4000:], file=sys.stderr)
                return 1
            rows.append(json.loads(got.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    if args.build_genomes:
        with tempfile.TemporaryDirectory() as tmp:
            genomes = _genomes(args, Path(tmp))
            for rep in range(args.reps):
                for root in roots if rep % 2 == 0 else roots[::-1]:
                    rows.append(_build(str(Path(root).resolve()), genomes, args.device))
                    print(json.dumps(rows[-1]), flush=True)
    summary = _machine(args.device)
    for root in roots:
        mine = [r for r in rows if Path(r["root"]).resolve() == Path(root).resolve()]
        summary[root] = {key: statistics.median(r[key] for r in mine if key in r)
                         for key in ("save_s", "save_gb_per_s", "save_rss_bytes", "bincode_s", "prebuilt_s",
                                     "drain_gb_per_s", "build_wall_s", "build_peak_rss_bytes")
                         if any(key in r for r in mine)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
