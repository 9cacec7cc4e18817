"""Run a cell's control on the card: the plain reference, with one
guarantee that the configuration states broken, put in the program's
place, judged as a run judges the program's calls.  It has to come out
not correct.

    python3 h100bench/control.py --workload <cell> --seeds <n>,<n>,...

Count and build key the k-mers by a 40-bit hash, as an approximate counter
or set would; query counts a read's hits on a 1-in-10 hash sample of its
windows, scaled by 10, as a sketch-based screen would.  The benchmark's own
runs never run this.  Prints one JSON line a seed, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from h100bench.harness import card, runner  # noqa: E402
from h100bench.harness.inputs import Workdir  # noqa: E402
from h100bench.harness.manifest import Manifest  # noqa: E402


def control_checks(workload: str, seed: int, device: str = "cuda", config_override: dict | None = None,
                   root: Path = ROOT) -> dict:
    import torch

    workdir = Workdir()
    ctx = None
    try:
        with ThreadPoolExecutor(2) as pool:
            t = time.monotonic()
            ctx = runner.prepare(Manifest(root), workload, seed, torch.device(device), workdir, pool,
                                 config_override, log=lambda msg: None)
            t_inputs = time.monotonic() - t
            t = time.monotonic()
            expected = ctx.job.expected()
            t_ref = time.monotonic() - t
            t = time.monotonic()
            control = runner.resolve(ctx.job.control())
            t_ctl = time.monotonic() - t
            checks = ctx.job.judge([control], expected)
        return {
            "workload": workload, "seed": seed, "correct": all(v <= lim for _, v, lim in checks),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
            "expected": expected, "control": control,
            "seconds": {"inputs": t_inputs, "reference": t_ref, "control": t_ctl},
        }
    finally:
        if ctx is not None:
            ctx.job.close()
        workdir.close()


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds, three or more")
    args = p.parse_args(argv)
    runner.prepare_environment(ROOT)
    card.require_cards(1)
    card.log(f"card: {card.power_limit()}")
    results = [control_checks(args.workload, int(s)) for s in args.seeds.split(",")]
    for r in results:
        print(json.dumps(r, default=str), flush=True)
    failed = sum(not r["correct"] for r in results)
    print(json.dumps({"workload": args.workload, "seeds": len(results), "control_not_correct": failed}))
    return 0 if failed == len(results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
