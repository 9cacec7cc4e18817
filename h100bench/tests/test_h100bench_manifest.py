"""BENCHMARK.json against the rules on names, units and files; every
configuration has its tiny size and every command its faults; a cell and a
configuration added by dropping in new files."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from h100bench.harness import manifest
from h100bench.tests.helpers import FAULTS, ROOT, commands, configs, faults, run_tiny, tiny

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
END_TO_END_SOURCES = {"device_trace", "host_clock"}


def problems(data: dict, root: Path | None = None) -> list[str]:
    """What in a ``BENCHMARK.json`` breaks the rules on names, units,
    sources and cross references; with ``root``, also the files each name
    has to find."""
    out = []
    configs = {c["name"] for c in data["configs"]}
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"] for m in data["end_to_end"]}
    seen: set[str] = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in data[kind]:
            name = entry["name"]
            if not NAME.fullmatch(name):
                out.append(f"{kind}: bad name {name!r}")
            if name in seen and kind != "configs":
                out.append(f"{kind}: {name!r} used twice")
            seen.add(name)
    for w in data["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.fullmatch(w[key]):
                out.append(f"workload {w['name']}: bad {key} {w[key]!r}")
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']}")
        if root is not None and not (root / "h100bench" / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"workload {w['name']}: no traffic file {w['traffic']}.json")
    for c in data["configs"]:
        for key in c["reduced"]:
            if not NAME.fullmatch(key):
                out.append(f"config {c['name']}: bad reduced key {key!r}")
        if root is not None and not (root / c["file"]).exists():
            out.append(f"config {c['name']}: no file {c['file']}")
    for kind in ("end_to_end", "per_layer"):
        for m in data[kind]:
            if not UNIT.fullmatch(m["unit"]):
                out.append(f"{m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"{m['name']}: better {m['better']!r}")
            allowed = END_TO_END_SOURCES if kind == "end_to_end" else SOURCES
            if m["source"] not in allowed:
                out.append(f"{m['name']}: source {m['source']!r}")
            for cell in m.get("workloads", []):
                if cell not in cells:
                    out.append(f"{m['name']}: unknown workload {cell!r}")
            if kind == "per_layer" and m["moves"] not in e2e:
                out.append(f"{m['name']}: moves unknown metric {m['moves']!r}")
            if root is not None and not (root / "h100bench" / "metrics" / f"{m['name']}.py").exists():
                out.append(f"{m['name']}: no reader {m['name']}.py")
    for text_key in ("why", "layer", "source"):
        for kind in ("configs", "workloads", "per_layer"):
            for entry in data[kind]:
                v = entry.get(text_key)
                if isinstance(v, str) and not (1 <= len(v) <= 200 and "\n" not in v and "\t" not in v):
                    out.append(f"{entry['name']}: bad {text_key}")
    return out


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_has_no_problems():
    assert problems(load(), ROOT) == []


@pytest.mark.parametrize("name,ok", [
    ("count-k31", True), ("parse_mbp_per_s.count", True), ("_x", True), ("a" * 64, True),
    ("a" * 65, False), ("has space", False), ("a,b", False), ("a/b", False), (".x", False), ("µs", False),
])
def test_name_rule(name, ok):
    assert bool(NAME.fullmatch(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("kmers/s", True), ("%", True), ("s/Gbp", True), ("launches/Gbp", True), ("Mbp/s", True),
    ("tokens per second", False), ("", False), ("a" * 17, False), ("µs", False),
])
def test_unit_rule(unit, ok):
    assert bool(UNIT.fullmatch(unit)) is ok


def test_problems_are_found():
    data = load()
    data["per_layer"][0]["unit"] = "per second"
    data["per_layer"][1]["moves"] = "nothing"
    data["workloads"][0]["config"] = "missing"
    found = problems(data, ROOT)
    assert len(found) == 3, found


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    man = manifest.Manifest(ROOT)
    for w in man.data["workloads"]:
        e2e = [m["name"] for m in man.metrics_of("end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.metrics_of("per_layer", w["name"])
        for m in man.metrics_of("per_layer", w["name"]):
            assert m["moves"] in e2e


def _tree_hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_by_new_files_alone(tmp_path):
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _tree_hashes(tmp_path / "h100bench")
    (tmp_path / "h100bench" / "traffic" / "count-k25.json").write_text(
        '{"command": "count", "k": 25, "min_count": 3, "histogram": false}\n')
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "count-k25", "config": "ecoli-illumina-1gbp", "traffic": "count-k25",
                              "chips": 1, "why": "a cell added by data alone"})
    data["end_to_end"][0]["workloads"].append("count-k25")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    after = _tree_hashes(tmp_path / "h100bench")
    assert {p: h for p, h in after.items() if p in before} == before  # nothing edited
    assert problems(data, tmp_path) == []
    result = run_tiny("count-k25", root=tmp_path)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"host_cpu_s_per_gbp", "setup_s"}
    assert list(result["checks"]) == ["tsv_calls_differing", "failed_calls"]


@pytest.mark.parametrize("config", configs())
def test_every_config_has_a_tiny_size(config):
    man = manifest.Manifest(ROOT)
    small = tiny(man, config)
    full = man.config(config)
    assert small and set(small) <= set(full)
    assert man.generator({**full, **small}["generator"]).make


@pytest.mark.parametrize("command", commands())
def test_every_command_has_its_faults(command):
    module = faults(manifest.Manifest(ROOT), command)
    assert all(callable(getattr(module, name, None)) for name in FAULTS)


GENERATOR = """from pathlib import Path

from h100bench.harness.manifest import load_module

reads = load_module(Path(__file__).with_name("illumina_reads.py"), "generator")


def make(cfg, seed, workdir, device):
    return reads.make(cfg, seed, workdir, device)
"""


def test_a_config_added_by_new_files_alone(tmp_path):
    """A configuration with a generator of its own (one that reuses
    ``illumina_reads``), a traffic file, its tiny size and a cell, as new
    files and entries only."""
    bench = tmp_path / "h100bench"
    shutil.copytree(ROOT / "h100bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _tree_hashes(bench)
    name = "ecoli-illumina-halfgbp"
    cfg = {**manifest.load_json(bench / "configs" / "ecoli-illumina-1gbp.json"), "name": name,
           "generator": "illumina_reads_half", "gbp": 0.5}
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "generators" / "illumina_reads_half.py").write_text(GENERATOR)
    (bench / "traffic" / "count-k25.json").write_text(
        '{"command": "count", "k": 25, "min_count": 2, "histogram": true}\n')
    (bench / "tests" / "tiny" / f"{name}.json").write_text(
        json.dumps(tiny(manifest.Manifest(ROOT), "ecoli-illumina-1gbp")))
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["configs"].append({"name": name, "source": "a configuration added by data alone",
                            "file": f"h100bench/configs/{name}.json", "reduced": ["gbp"],
                            "why": "a configuration added by data alone"})
    data["workloads"].append({"name": "count-k25.half", "config": name, "traffic": "count-k25", "chips": 1,
                              "why": "a cell of a configuration added by data alone"})
    data["end_to_end"][0]["workloads"].append("count-k25.half")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    after = _tree_hashes(bench)
    assert {p: h for p, h in after.items() if p in before} == before  # nothing edited
    assert problems(data, tmp_path) == []
    assert name in configs(tmp_path) and commands(tmp_path) == commands()
    result = run_tiny("count-k25.half", root=tmp_path)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"host_cpu_s_per_gbp", "setup_s"}
    assert list(result["checks"]) == ["tsv_calls_differing", "histogram_calls_differing", "failed_calls"]
