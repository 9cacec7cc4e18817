"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, command or
metric sits in a file of its own under ``h100bench/``, found by its name:

- ``configs/<config>.json``: the deployment's sizes; ``generator`` names
  ``generators/<generator>.py``, which makes its inputs from the seed;
- ``traffic/<traffic>.json``: the command and its flags; ``command`` names
  ``commands/<command>.py``, which builds each call and judges its output
  against ``reference/<command>.py``;
- ``metrics/<metric>.py``: the reader of one metric, ``read(ctx)``.

So a cell, a configuration or a metric is added by adding files and
entries, without editing a file that is there.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """The module in ``path``, loaded by file, under a name of its own
    (metric files have dots in their names)."""
    tag = hashlib.sha256(str(path.resolve()).encode()).hexdigest()[:8]
    name = f"h100bench_{prefix}_{re.sub(r'\W', '_', path.stem)}_{tag}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Manifest:
    """``BENCHMARK.json`` of a checkout, and the harness's files beside it."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = load_json(self.root / "BENCHMARK.json")
        self.bench = self.root / "h100bench"

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.bench / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.bench / "traffic" / f"{name}.json")

    def generator(self, name: str):
        return load_module(self.bench / "generators" / f"{name}.py", "generator")

    def command(self, name: str):
        return load_module(self.bench / "commands" / f"{name}.py", "command")

    def metric_reader(self, name: str):
        return load_module(self.bench / "metrics" / f"{name}.py", "metric")

    def metrics_of(self, kind: str, cell: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
        reports, in the file's order."""
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]
