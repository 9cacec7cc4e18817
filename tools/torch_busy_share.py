#!/usr/bin/env python3
"""Device busy share of the port's commands on one NVIDIA GPU.

    python3 tools/torch_busy_share.py [--seed N] [--gbp G]

Makes the inputs of ``chip_smoke.py`` phases 5 and 7 from the seed (the
E. coli-like reads and the 50 clade genomes), then runs, in this
process, `count -k 31 -m 2` of the reads, `sketch -k 31 --scaled 1000` of
the genomes and `sketch` of the reads, after one warm-up command: each
once plain, for its wall time, then once under torch.profiler (CUDA
activity only), for its device time.  The busy share is the device time
(every kernel and copy) over the plain wall.  Prints one JSON line per command with the card's
name and power limit and the five kernels with the most device time.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gbp", type=float, default=0.5, help="Gbp of reads")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from orion_kmer_tpu_torch import cli

    if not torch.cuda.is_available():
        raise SystemExit("torch_busy_share: no CUDA device")
    card = chip_smoke.gpu_name_and_limit()
    work = ROOT / "build" / "busy_share"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        rng = np.random.default_rng(args.seed)
        fq = work / "reads.fastq"
        chip_smoke.write_reads_fastq(np, fq, rng, args.gbp)
        paths, _ = chip_smoke.write_clades(np, work, rng)
        # warm-up: the kernel library's build and load, the CUDA context
        chip_smoke.check(cli.main(["count", "-k", "31", "-i", str(paths[0]), "-o", str(work / "w.tsv")]) == 0,
                         "warm-up exit code")
        commands = {
            "count reads": ["count", "-k", "31", "-m", "2", "-i", fq, "-o", work / "c.tsv"],
            "sketch genomes": ["sketch", "-k", "31", "--scaled", "1000", "-i", *paths, "-o", work / "g.sig"],
            "sketch reads": ["sketch", "-k", "31", "--scaled", "1000", "-i", fq, "-o", work / "r.sig"],
        }
        for name, argv in commands.items():
            argv = [str(a) for a in argv]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            chip_smoke.check(cli.main(argv) == 0, f"{name} exit code")
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                chip_smoke.check(cli.main(argv) == 0, f"{name} exit code")
                torch.cuda.synchronize()
            by_kernel = sorted(
                ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()),
                key=lambda kv: -kv[1],
            )
            device_ms = sum(ms for _, ms in by_kernel)
            print(json.dumps({
                "command": name, "card": card, "wall_s": wall, "device_ms": device_ms,
                "busy_share": device_ms / 1e3 / wall,
                "top_kernels_ms": [[k[:80], ms] for k, ms in by_kernel[:5]],
            }), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
