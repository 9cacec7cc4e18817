#!/usr/bin/env python3
"""Wall time of the port's CLI in two checkouts, in alternating pairs on one card.

    python3 tools/torch_cli_ab.py --parent DIR [--change DIR] [--pairs N] [--gbp G] [--threads T]
                                  [--commands count,sketch,query]

Makes the E. coli-like reads of ``chip_smoke.py`` phase 5 once, and the
DB of phase 6 (``build -k 31`` of its three references, the first the
reads' genome, built once by the change), then runs `count -k 31 -m 2
--histogram`, `sketch -k 31 --scaled 1000` and `query -c 10` of the reads
against that DB as `python -m orion_kmer_tpu_torch` subprocesses from the
parent's checkout and from the change's (default: this one), with
ORION_KMER_SHARDS=0: one
untimed run each (it builds that checkout's kernels), then N pairs,
alternating which side runs first, each with `-t T` (default 0: every
core).  The wall is the subprocess's, process
start included: what a user of the CLI waits for; beside it the process's
peak RSS, sampled every 10 ms as ``chip_smoke.py`` phase 5 samples it.
Both sides must write the same bytes.  To compare a commit with its parent, unpack the parent
with ``git archive`` into a directory that .gitignore lists.  Prints one
JSON line per command: every wall, the medians, the distance between the
parent's quartiles, and the pairs each side won.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def run(root: Path, argv, peak_path: Path) -> tuple[float, int]:
    """One CLI call in a fresh process from ``root``: (wall s, peak RSS
    bytes sampled every 10 ms, as ``chip_smoke.py`` phase 5 samples it)."""
    import chip_smoke

    env = dict(os.environ, ORION_KMER_SHARDS="0")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", chip_smoke._CLI_PEAK, str(peak_path), *map(str, argv)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=900)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {argv} failed: {proc.stderr[-2000:]}")
    return wall, int(peak_path.read_text())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--change", default=str(HERE), help="checkout of the change")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gbp", type=float, default=0.5, help="Gbp of reads")
    ap.add_argument("--threads", type=int, default=0, help="-t of every command (0: every core)")
    ap.add_argument("--commands", default="count,sketch,query", help="which commands to time, in order")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("torch_cli_ab: no CUDA device")
    roots = {"parent": Path(args.parent).resolve(), "change": Path(args.change).resolve()}
    card = chip_smoke.gpu_name_and_limit()
    work = HERE / "build" / "cli_ab"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        fq = work / "reads.fastq"
        peak = work / "peak"
        rng = np.random.default_rng(args.seed)
        _, _, genome, _ = chip_smoke.write_reads_fastq(np, fq, rng, args.gbp)
        db = work / "refs.db"
        if "query" in args.commands:
            refs = chip_smoke.write_references(np, work, rng, genome)
            run(roots["change"], ["build", "-k", 31, "-g", *(path for path, _ in refs.values()), "-o", db], peak)
        commands = {
            "count": lambda side: ["-t", args.threads, "count", "-k", 31, "-m", 2, "--histogram", work / f"{side}.hist",
                                   "-i", fq, "-o", work / f"{side}.tsv"],
            "sketch": lambda side: ["-t", args.threads, "sketch", "-k", 31, "--scaled", 1000, "-i", fq, "-o", work / f"{side}.sig"],
            "query": lambda side: ["-t", args.threads, "query", "-d", db, "-r", fq, "-c", 10, "-o", work / f"{side}.ids"],
        }
        outputs = {"count": (".tsv", ".hist"), "sketch": (".sig",), "query": (".ids",)}
        for name in args.commands.split(","):
            argv = commands[name]
            walls = {"parent": [], "change": []}
            rss = {"parent": [], "change": []}
            for side, root in roots.items():
                run(root, argv(side), peak)  # untimed: builds this checkout's kernels
            for suffix in outputs[name]:
                chip_smoke.check((work / f"parent{suffix}").read_bytes() == (work / f"change{suffix}").read_bytes(),
                                 f"{name}: both checkouts write the same {suffix}")
            for pair in range(args.pairs):
                for side in (("parent", "change") if pair % 2 == 0 else ("change", "parent")):
                    wall, peak_rss = run(roots[side], argv(side), peak)
                    walls[side].append(wall)
                    rss[side].append(peak_rss)
            q = statistics.quantiles(walls["parent"], n=4)
            print(json.dumps({
                "command": name, "threads": args.threads, "card": card, "pairs": args.pairs,
                "parent_s": walls["parent"], "change_s": walls["change"],
                "parent_median_s": statistics.median(walls["parent"]),
                "change_median_s": statistics.median(walls["change"]),
                "parent_quartile_distance_s": q[2] - q[0],
                "pairs_won_by_change": sum(c < p for p, c in zip(walls["parent"], walls["change"])),
                "pairs_won_by_parent": sum(p < c for p, c in zip(walls["parent"], walls["change"])),
                "parent_peak_rss_bytes": rss["parent"], "change_peak_rss_bytes": rss["change"],
                "parent_median_peak_rss_gib": statistics.median(rss["parent"]) / 2**30,
                "change_median_peak_rss_gib": statistics.median(rss["change"]) / 2**30,
            }), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
