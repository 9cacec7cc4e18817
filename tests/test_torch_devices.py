"""Every kernel wrapper launches on the device of its operands.

The C entries launch on the thread's current CUDA device, so each wrapper
must call them under ``_kernels.on_device(operand)``.  There is no card
here: the operands are meta tensors (neither CPU nor CUDA, no storage),
and the library, the stream lookup, the operand check and the device
guard are replaced by recorders.  What is checked is that every C entry
is called inside the guard of the operands' own device, and nowhere else.
"""

import contextlib
import re
from pathlib import Path

import pytest
import torch

import orion_kmer_tpu_torch
from orion_kmer_tpu_torch import _kernels
from orion_kmer_tpu_torch.ops import compact, extract, merge, sort

CSRC = Path(orion_kmer_tpu_torch.__file__).resolve().parent / "csrc"


class Recorder:
    """Stands in for the kernel library: every ``okt_*`` entry records its
    name and the device guarded at the time of the call."""

    def __init__(self):
        self.guarded = None
        self.calls = []

    @contextlib.contextmanager
    def on_device(self, t):
        assert self.guarded is None, "nested guards"
        self.guarded = t.device
        try:
            yield
        finally:
            self.guarded = None

    def __getattr__(self, name):
        if not name.startswith("okt_"):
            raise AttributeError(name)
        sizes = {"okt_extract_blocks": 3, "okt_compact_workspace": 7, "okt_merge_scratch": 5}

        def entry(*args):
            self.calls.append((name, self.guarded))
            return sizes.get(name, 0)

        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(_kernels, "lib", lambda: rec)
    monkeypatch.setattr(_kernels, "on_device", rec.on_device)
    monkeypatch.setattr(_kernels, "require_cuda", lambda name, *tensors: None)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda t: 0)
    return rec


def _meta(n, dtype=torch.int64):
    return torch.empty(n, dtype=dtype, device="meta")


LAUNCHES = {
    "K1 extract": (extract, lambda: extract.extract_keys(_meta(8, torch.int32), _meta(4, torch.int32), 21, 100),
                   {"okt_extract_blocks", "okt_extract"}),
    "K2 merge": (merge, lambda: merge.merge(_meta(8), _meta(5), _meta(8), _meta(5)), {"okt_merge"}),
    "K3 compact": (compact, lambda: compact.compact([_meta(9), _meta(9)], _meta(9, torch.bool)),
                   {"okt_compact"}),
    "K3 compact one plane": (compact, lambda: compact.compact([_meta(9)], _meta(9, torch.bool)), {"okt_compact"}),
    "K3 compact positions": (compact, lambda: compact.compact_positions(_meta(9), _meta(9, torch.bool), _meta(())),
                             {"okt_compact"}),
    "K3 compact route": (compact, lambda: compact.partition(_meta(9), 5), {"okt_compact_route"}),
    "K4 sort": (sort, lambda: sort.sort_pairs(_meta(100)), {"okt_sort"}),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_wrapper_launches_under_its_operands_device(recorder, monkeypatch, name):
    module, call, entries = LAUNCHES[name]
    monkeypatch.setattr(module, "launches", 0)
    call()
    device_bound = [(n, dev) for n, dev in recorder.calls if n in entries]
    assert {n for n, _ in device_bound} == entries
    assert all(dev == torch.device("meta") for _, dev in device_bound), recorder.calls
    assert module.launches == 1
    assert recorder.guarded is None


def test_on_device_is_the_tensors_cuda_device(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: seen.append(d) or contextlib.nullcontext())
    t = _meta(4)
    with _kernels.on_device(t):
        pass
    assert seen == [t.device]


def test_no_wrapper_calls_a_launching_entry_outside_the_guard():
    """Source check: in ops/, every call of a C entry that launches or
    reads the device sits in a ``with _kernels.on_device(...)`` block."""
    ops = Path(orion_kmer_tpu_torch.__file__).resolve().parent / "ops"
    device_bound = re.compile(r"\.okt_(extract_blocks|extract|merge|compact|compact_route|sort)\(")
    for path in sorted(ops.glob("*.py")):
        guard_indent = None
        for line in path.read_text().splitlines():
            indent = len(line) - len(line.lstrip())
            if guard_indent is not None and line.strip() and indent <= guard_indent:
                guard_indent = None
            if "with _kernels.on_device(" in line:
                guard_indent = indent
            if device_bound.search(line):
                assert guard_indent is not None, f"{path.name}: {line.strip()}"


def test_extract_keeps_its_configured_flag_per_device():
    """``cudaFuncSetAttribute`` holds per device: the flag that skips it is
    indexed by (device, k), and the grid follows the current device."""
    src = (CSRC / "extract.cu").read_text()
    assert re.search(r"g_configured\[kMaxDevices\]\[32\]", src)
    assert "g_configured[dev][k - 1]" in src
    assert not re.search(r"g_configured\[k - 1\]", src)
    assert src.count("cudaGetDevice(&dev)") == 2  # the grid's SM count and the flag
    for name in ("merge.cu", "compact.cu", "sort.cu"):
        assert "cudaFuncSetAttribute" not in (CSRC / name).read_text(), name


def test_signatures_match_the_c_entries():
    """Source check: every ``extern "C"`` entry of csrc/ is bound in
    ``_kernels._SIGNATURES`` with its return type and one ctypes type per
    parameter (pointers as c_void_p, int64_t as c_int64), and nothing else
    is bound."""
    import ctypes

    ctype = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "const char*": ctypes.c_char_p}
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" ([\w ]+\*?) (okt_\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(3).split(",") if p.strip()]
            types = [ctypes.c_void_p if "*" in p else ctype[p.rsplit(" ", 1)[0]] for p in params]
            found[m.group(2)] = (ctype[m.group(1)], types)
    assert set(found) == set(_kernels._SIGNATURES)
    for name, (restype, argtypes) in _kernels._SIGNATURES.items():
        assert (restype, list(argtypes)) == found[name], name
