"""Tiny sizes of the benchmark's configurations, for runs on the CPU, and
the cells put off (``h100bench/put_off.json``) added back for the tests."""

from __future__ import annotations

import atexit
import json
import shutil
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PUT_OFF = ROOT / "h100bench" / "put_off.json"

TINY = {
    "ecoli-illumina-1gbp": {
        "genome_bp": 20_000, "gbp": 0.0003, "block_reads": 700, "n_read_share": 0.05,
        "references": {"strain_substitution_rate": 0.01, "unrelated_bp": 20_000},
    },
    "bacteria-50x5mbp": {"n_genomes": 4, "n_clades": 2, "genome_bp": 20_000},
}


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def with_put_off(data: dict) -> dict:
    """``data`` (a ``BENCHMARK.json``) with the cells put off added back:
    their workloads, their metrics, and their names in the ``workloads``
    of the metrics they share."""
    off = json.loads(PUT_OFF.read_text())
    data = json.loads(json.dumps(data))
    data["workloads"] += off["workloads"]
    for kind in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in data[kind]}
        for m in off[kind]:
            if m["name"] in have:
                have[m["name"]]["workloads"] += m["workloads"]
            else:
                data[kind].append(m)
    return data


_put_off_root: Path | None = None


def root_for(workload: str) -> Path:
    """The checkout whose ``BENCHMARK.json`` holds ``workload``: this one,
    or for a cell put off a copy of its ``BENCHMARK.json`` with the cells
    put off added back, beside a link to this ``h100bench/``."""
    global _put_off_root
    if any(w["name"] == workload for w in benchmark()["workloads"]):
        return ROOT
    if _put_off_root is None:
        root = Path(tempfile.mkdtemp(prefix="h100bench-put-off-"))
        atexit.register(shutil.rmtree, root, True)
        (root / "h100bench").symlink_to(ROOT / "h100bench", target_is_directory=True)
        (root / "BENCHMARK.json").write_text(json.dumps(with_put_off(benchmark())))
        _put_off_root = root
    return _put_off_root


def tiny_config(manifest, workload: str) -> dict:
    return TINY[manifest.workload(workload)["config"]]


def run_tiny(workload: str, seed: int = 2**31 + 7, root: Path | None = None, seconds: float = 0.3,
             trace: bool = False, override: dict | None = None, device: str = "cpu") -> dict:
    """One run of a cell at a tiny size, on the CPU (no look for a card)
    unless ``device`` is ``cuda``."""
    from h100bench.harness import runner
    from h100bench.harness.manifest import Manifest

    root = root_for(workload) if root is None else root
    runner.prepare_environment(ROOT)
    cfg = {**tiny_config(Manifest(root), workload), **(override or {})}
    return runner.run(workload, seed, seconds, trace, time.monotonic(), root=root, device=device,
                      config_override=cfg, log=lambda msg: None)
