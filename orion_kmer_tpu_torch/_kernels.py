"""Build and load the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``.  The build
happens once, at first use, into
``build/okt_torch_kernels/<hash of the sources>/`` at the repository root
(``$ORION_KMER_BUILD_DIR/okt_torch_kernels/...`` where that is set),
from the sources in the repository and nothing else.  Importing this
module builds nothing: the CPU path never calls ``lib()``.

Each C entry launches on the thread's current CUDA device and returns
``cudaGetLastError()`` after its launches; the wrappers of ``ops/`` call
them under ``on_device(operand)``, and ``check`` turns a non-zero code
into an exception.  nvcc runs with ``-Xptxas -v``;
its report (registers, shared memory and spills of every kernel) is kept
beside the library as ``ptxas.txt`` and parsed by ``ptxas_report()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

logger = logging.getLogger("orion_kmer_tpu_torch.kernels")

_PKG = Path(__file__).resolve().parent
_SRC_DIR = _PKG / "csrc"
# where the library is built: ORION_KMER_BUILD_DIR, read at each build,
# else build/ at the repository root
_DEFAULT_BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "okt_extract_blocks": (_I, [_I]),
    "okt_extract": (ctypes.c_int, [_P, _P, _I, _I, _I, _P, _P, _P]),
    "okt_merge_scratch": (_I, [_I]),
    "okt_merge": (ctypes.c_int, [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P]),
    "okt_compact_workspace": (_I, [_I, _I]),
    "okt_compact": (ctypes.c_int, [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P]),
    "okt_compact_route": (ctypes.c_int, [_P, _I, _I, _P, _P, _P]),
    "okt_sort_max_n": (_I, []),
    "okt_sort": (ctypes.c_int, [_P, _I, _P, _P]),
    "okt_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

_REPORT = "ptxas.txt"
_lock = threading.Lock()
_lib = None
_so_path = None


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cu")) + sorted(_SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> Path:
    srcs = _sources()
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    build_dir = Path(os.environ.get("ORION_KMER_BUILD_DIR", _DEFAULT_BUILD_DIR))
    out_dir = build_dir / "okt_torch_kernels" / h.hexdigest()[:16]
    so_path = out_dir / "libokt_torch_kernels.so"
    if so_path.exists():
        return so_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in srcs if s.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        logger.info("Building CUDA kernels: %s", " ".join(cmd))
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, report = [], []
    for obj, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {obj.name}:\n{err}")
        report.append(err)
    if failed:
        raise RuntimeError("\n".join(failed))
    report_tmp = out_dir / f"{_REPORT}.{tag}.tmp"
    report_tmp.write_text("".join(report))
    os.replace(report_tmp, out_dir / _REPORT)  # before the library, which marks a finished build
    tmp = out_dir / f"libokt_torch_kernels.{tag}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(obj) for obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    for obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, so_path)
    return so_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _so_path
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _so_path = _build()
            so = ctypes.CDLL(str(_so_path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = so
    return _lib


def _demangle(names: list[str]) -> list[str]:
    cands = [shutil.which("cu++filt"), Path(_nvcc()).parent / "cu++filt", shutil.which("c++filt")]
    tool = next((str(c) for c in cands if c and Path(c).exists()), None)
    if not names or tool is None:
        return names
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    out = proc.stdout.splitlines()
    return out if proc.returncode == 0 and len(out) == len(names) else names


def ptxas_report() -> list[dict]:
    """Per kernel of the loaded library, from ptxas: ``name`` (demangled
    where a demangler is found), ``registers``, ``spill_stores`` and
    ``spill_loads`` in bytes."""
    lib()
    kernels = parse_ptxas((_so_path.parent / _REPORT).read_text())
    for k, name in zip(kernels, _demangle([k["name"] for k in kernels])):
        k["name"] = name
    return kernels


def parse_ptxas(text: str) -> list[dict]:
    """``-Xptxas -v`` output -> per kernel ``name`` (mangled),
    ``registers``, ``spill_stores`` and ``spill_loads``."""
    kernels, cur = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = {"name": m.group(1), "registers": None, "spill_stores": 0, "spill_loads": 0}
            kernels.append(cur)
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m.group(1))
    return kernels


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = lib().okt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t):
    """Context that makes ``t``'s device the thread's current CUDA device.

    The C entries launch on whatever device is current and read that
    device's properties (SM count, per-device function attributes), so
    every wrapper calls them inside this context: a kernel then runs on
    the card that holds its operands, whichever card the caller has
    current."""
    import torch

    return torch.cuda.device(t.device)


def require_cuda(name: str, *tensors) -> None:
    """Check that the kernel's operands are contiguous CUDA tensors on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
