"""Build and load the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
build happens once, at first use, into
``build/okt_torch_kernels/<hash of the sources>/`` at the repository root,
from the sources in the repository and nothing else.  Importing this
module builds nothing: the CPU path never calls ``lib()``.

Each C entry returns ``cudaGetLastError()`` after its launches; ``check``
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

logger = logging.getLogger("orion_kmer_tpu_torch.kernels")

_PKG = Path(__file__).resolve().parent
_SRC_DIR = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "okt_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "okt_extract_blocks": (_I, [_I]),
    "okt_extract": (ctypes.c_int, [_P, _P, _I, _I, _I, _P, _P, _P]),
    "okt_merge_scratch": (_I, [_I]),
    "okt_merge": (ctypes.c_int, [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P]),
    "okt_compact_blocks": (_I, [_I]),
    "okt_compact_count": (ctypes.c_int, [_P, _I, _P, _P]),
    "okt_compact_scatter": (ctypes.c_int, [_P, _I, _P, _P, _P, _P, _P, _P]),
    "okt_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

_lock = threading.Lock()
_lib = None


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
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    so_path = out_dir / "libokt_torch_kernels.so"
    if so_path.exists():
        return so_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libokt_torch_kernels.{os.getpid()}.tmp"
    cus = [str(s) for s in srcs if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cus]
    logger.info("Building CUDA kernels: %s", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(_build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = so
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = lib().okt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Check that the kernel's operands are contiguous CUDA tensors on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
