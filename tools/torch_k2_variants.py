#!/usr/bin/env python3
"""K2 (csrc/merge.cu) rebuilt with other values of its layout constants,
timed on one card.

    python3 tools/torch_k2_variants.py [--only NAME ...]

Each variant is the kernel source of this checkout with some of
``kThreads`` (threads a block) and ``kItemsKeys`` and ``kItemsPayload``
(outputs a thread merges, odd, keys only and with a payload or counts; a
tile is kThreads times that) set to other values (VARIANTS).  Every
variant is built by its own nvcc (all started together) into a temporary
library, put behind the wrappers of ``ops/merge.py``, checked against the
plain versions at every shape of ``chip_smoke.k2_shapes`` and timed there
with ``chip_smoke.median_ms``.  Prints one JSON line per variant.  Needs
nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# name -> {constant of merge.cu: its value in this variant}
VARIANTS = {
    "as built": {},
    "keys 15": {"kItemsKeys": "15"},
    "keys 23": {"kItemsKeys": "23"},
    "keys 31": {"kItemsKeys": "31"},
    "keys 35": {"kItemsKeys": "35"},
    "keys 37": {"kItemsKeys": "37"},
    "keys 39": {"kItemsKeys": "39"},
    "keys 43": {"kItemsKeys": "43"},
    "keys 47": {"kItemsKeys": "47"},
    "payload 7": {"kItemsPayload": "7"},
    "payload 11": {"kItemsPayload": "11"},
    "payload 13": {"kItemsPayload": "13"},
    "payload 17": {"kItemsPayload": "17"},
    "256 threads, keys 15, payload 7": {"kThreads": "256", "kItemsKeys": "15", "kItemsPayload": "7"},
}


def build(name: str, values: dict, out_dir: Path):
    from orion_kmer_tpu_torch import _kernels

    src = (ROOT / "orion_kmer_tpu_torch" / "csrc" / "merge.cu").read_text()
    for const, value in values.items():
        src, n = re.subn(rf"(constexpr int {const} = )[^;]+;", rf"\g<1>{value};", src)
        chip_smoke.check(n == 1, f"one definition of {const} in merge.cu ({name})")
    src += '\nextern "C" const char* okt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }\n'
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = out_dir / f"{tag}.cu", out_dir / f"{tag}.so"
    cu.write_text(src)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(so: Path):
    from orion_kmer_tpu_torch import _kernels

    lib = ctypes.CDLL(str(so))
    for name in ("okt_merge", "okt_error_string"):
        restype, argtypes = _kernels._SIGNATURES[name]
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", help="variant names to run (default: all)")
    args = ap.parse_args()
    import torch

    from orion_kmer_tpu_torch import _kernels

    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_variants: no CUDA device")
    dev = torch.device("cuda")
    names = list(args.only or VARIANTS)
    card = chip_smoke.gpu_name_and_limit()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {name: build(name, VARIANTS[name], Path(tmp)) for name in names}
        libs = {}
        for name, (so, proc) in jobs.items():
            _, err = proc.communicate()
            chip_smoke.check(proc.returncode == 0, f"nvcc for {name}:\n{err}")
            regs = [line.strip() for line in err.splitlines() if "registers" in line or "spill" in line]
            libs[name] = (load(so), regs)
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)
        cases = chip_smoke.k2_shapes(torch, dev, gen)
        for name in names:
            lib, regs = libs[name]
            _kernels._lib = lib  # the wrappers of ops/merge.py now launch this variant
            row = {"variant": name, "card": card, "ptxas": regs}
            for what, mode, call_args, n_bytes in cases:
                chip_smoke.k2_run(torch, f"{name}: {what}", mode, call_args)
                t = chip_smoke.median_ms(torch, lambda: chip_smoke.k2_call(mode, call_args))
                row[what] = {"ms": t, "share_of_bound": chip_smoke.bound_ms(n_bytes) / t}
            print(json.dumps(row), flush=True)
        _kernels._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
