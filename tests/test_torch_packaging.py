"""The port's packaging: ``pyproject.toml`` names its console script, its
``torch`` extra and the sources it builds from at run time, and its
kernel and parser builds honour ``ORION_KMER_BUILD_DIR``.

Tolerance: none, the checks are of names and files.
"""

import ctypes
import importlib
import tomllib
from pathlib import Path

from orion_kmer_tpu_torch import _kernels
from orion_kmer_tpu_torch.ingest import native

ROOT = Path(__file__).resolve().parent.parent


def test_pyproject_names_the_port():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    scripts = meta["project"]["scripts"]
    assert scripts["orion-kmer-tpu"] == "orion_kmer_tpu.cli:main"  # the reference's stays
    module, func = scripts["orion-kmer-tpu-torch"].split(":")
    assert callable(getattr(importlib.import_module(module), func))
    assert meta["project"]["optional-dependencies"]["torch"] == ["torch"]
    pkg = ROOT / "orion_kmer_tpu_torch"
    shipped = set()
    for pattern in meta["tool"]["setuptools"]["package-data"]["orion_kmer_tpu_torch"]:
        matched = sorted(pkg.glob(pattern))
        assert matched, f"{pattern} matches no file"
        shipped.update(matched)
    assert set(_kernels._sources()) | {native._SRC} <= shipped  # every source the two builds read


def test_native_parser_builds_into_the_build_dir_override(tmp_path, monkeypatch):
    monkeypatch.setenv("ORION_KMER_BUILD_DIR", str(tmp_path))
    so_path = native._compile()
    assert so_path.is_file() and so_path.is_relative_to(tmp_path / "okt_torch_native")
    assert ctypes.CDLL(str(so_path)).okt_pack_wire_multi  # the library loads
