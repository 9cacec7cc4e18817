#!/usr/bin/env python3
"""K3 (csrc/compact.cu) rebuilt with other values of its tuning constants,
timed on one card.

    python3 tools/torch_k3_variants.py [--only NAME ...]

Each variant is the kernel source of this checkout with one constant set
to another value (VARIANTS): ``kGatherBelow``, the kept count below which
a mask tile reads its kept elements where they lie instead of staging the
tile, or ``kMinBlocks``, the resident blocks a multiprocessor asked of the
register allocator.  Every variant is built by its own nvcc (all started
together) into a temporary library, put behind the wrappers of
``ops/compact.py``, checked against the plain versions and timed with
``chip_smoke.median_ms`` at the main path's shapes.  Prints one JSON line
per variant.  Needs nvcc and a card.
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

# name -> {constant of compact.cu: its value in this variant}
VARIANTS = {
    "as built": {},
    "masks never gather": {"kGatherBelow": "0"},
    "masks gather below kTile / 4": {"kGatherBelow": "kTile / 4"},
    "masks gather below kTile / 16": {"kGatherBelow": "kTile / 16"},
    "7 blocks/SM": {"kMinBlocks": "7"},
}


def build(name: str, values: dict, out_dir: Path):
    from orion_kmer_tpu_torch import _kernels

    src = (ROOT / "orion_kmer_tpu_torch" / "csrc" / "compact.cu").read_text()
    for const, value in values.items():
        src, n = re.subn(rf"(constexpr int {const} = )[^;]+;", rf"\g<1>{value};", src)
        chip_smoke.check(n == 1, f"one definition of {const} in compact.cu ({name})")
    src += '\nextern "C" const char* okt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }\n'
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = out_dir / f"{tag}.cu", out_dir / f"{tag}.so"
    cu.write_text(src)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(so: Path):
    from orion_kmer_tpu_torch import _kernels

    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _kernels._SIGNATURES.items():
        if name.startswith("okt_compact") or name == "okt_error_string":
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def shapes(torch, dev):
    """(name, kernel call, plain call, bytes) at the main path's shapes."""
    from orion_kmer_tpu_torch.keys import SENTINEL_KEY
    from orion_kmer_tpu_torch.ops import compact

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    n = 1 << 25
    x0 = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev, generator=gen)
    x1 = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev, generator=gen)
    out = []
    need = chip_smoke.k3_mask_bytes
    for density in (0.03, 0.97):
        keep = torch.rand(n, device=dev, generator=gen) < density
        out.append((f"two planes 2^25 d={density}", compact.compact, compact.compact_plain, ([x0, x1], keep),
                    need(keep, 2, 2)[0]))
    keep = torch.rand(n, device=dev, generator=gen) < 0.5
    out.append(("one plane 2^25 d=0.5", compact.compact, compact.compact_plain, ([x0], keep), need(keep, 1, 1)[0]))
    keep = torch.rand(n, device=dev, generator=gen) < 0.1
    out.append(("positions 2^25 d=0.1", compact.compact_positions, compact.compact_positions_plain, (x0, keep),
                need(keep, 1, 2)[0]))
    h = x0[: 1 << 24]
    keep = torch.rand(1 << 24, device=dev, generator=gen) < 1e-3
    out.append(("one plane 2^24 d=1/1000", compact.compact, compact.compact_plain, ([h], keep), need(keep, 1, 1)[0]))
    keys = x1[: 1 << 22].clone()
    keys[torch.rand(1 << 22, device=dev, generator=gen) < 0.05] = SENTINEL_KEY
    valid = int((keys != SENTINEL_KEY).sum())
    for n_dest in (4, 8):
        out.append((f"route 2^22 S={n_dest}", compact.partition, compact.partition_plain, (keys, n_dest),
                    (1 << 22) * 8 + valid * 8))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", help="variant names to run (default: all)")
    args = ap.parse_args()
    import torch

    from orion_kmer_tpu_torch import _kernels

    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_variants: no CUDA device")
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
        cases = shapes(torch, dev)
        for name in names:
            lib, regs = libs[name]
            _kernels._lib = lib  # the wrappers of ops/compact.py now launch this variant
            row = {"variant": name, "card": card, "ptxas": regs}
            for what, fn, plain, call_args, n_bytes in cases:
                got, want = chip_smoke.k3_outputs(*fn(*call_args)), chip_smoke.k3_outputs(*plain(*call_args))
                chip_smoke.check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{name}: {what} == plain")
                t = chip_smoke.median_ms(torch, lambda: fn(*call_args))
                row[what] = {"ms": t, "share_of_bound": chip_smoke.bound_ms(n_bytes) / t}
            print(json.dumps(row), flush=True)
        _kernels._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
