"""What the tests find by name, as the runner does (``harness/manifest.py``):
the cells, configurations and commands of ``BENCHMARK.json``, each
configuration's tiny size for runs on the CPU
(``tests/tiny/<config>.json``) and each command's planted faults
(``tests/faults/<command>.py``)."""

from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FAULTS = ("unchanged", "half_batch", "altered")


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cells(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in benchmark(root)["workloads"]]


def configs(root: Path = ROOT) -> list[str]:
    return [c["name"] for c in benchmark(root)["configs"]]


def commands(root: Path = ROOT) -> list[str]:
    """The commands the cells' traffic runs, each once, in the cells' order."""
    from h100bench.harness.manifest import Manifest

    man = Manifest(root)
    return list(dict.fromkeys(man.traffic(w["traffic"])["command"] for w in man.data["workloads"]))


def tiny(manifest, config: str) -> dict:
    """The keys of ``config`` that a run on the CPU overrides."""
    return json.loads((manifest.bench / "tests" / "tiny" / f"{config}.json").read_text())


def tiny_config(manifest, workload: str) -> dict:
    return tiny(manifest, manifest.workload(workload)["config"])


def faults(manifest, command: str):
    """The module of ``command``'s planted faults: one function of a
    ``monkeypatch`` for each name in ``FAULTS``."""
    from h100bench.harness.manifest import load_module

    return load_module(manifest.bench / "tests" / "faults" / f"{command}.py", "faults")


def run_tiny(workload: str, seed: int = 2**31 + 7, root: Path = ROOT, seconds: float = 0.3,
             trace: bool = False, override: dict | None = None, device: str = "cpu") -> dict:
    """One run of a cell at a tiny size, on the CPU (no look for a card)
    unless ``device`` is ``cuda``."""
    from h100bench.harness import runner
    from h100bench.harness.manifest import Manifest

    runner.prepare_environment(ROOT)
    cfg = {**tiny_config(Manifest(root), workload), **(override or {})}
    return runner.run(workload, seed, seconds, trace, time.monotonic(), root=root, device=device,
                      config_override=cfg, log=lambda msg: None)
