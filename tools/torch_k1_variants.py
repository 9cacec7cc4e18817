#!/usr/bin/env python3
"""K1 (csrc/extract.cu) rebuilt with other tile settings, timed on one card.

    python3 tools/torch_k1_variants.py

Each variant is the kernel source of this checkout with its constants
edited (threads per block, positions per thread, blocks per SM, one tile
buffer instead of two) or with the compute left out ("store only": every
key is its position, so only the staging and the TMA bulk stores remain).
Each is built with nvcc into a temporary library, checked against the
plain version at k = 31 (except "store only") and timed with
``chip_smoke.median_ms`` at 2^24 positions.  Prints one JSON line per
variant.  Needs nvcc and a card.
"""

from __future__ import annotations

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

VARIANTS = {
    "as built": {},
    "store only": {"store_only": True},
    "17 positions per thread, 6 blocks/SM": {"kRun": 17, "kBlocksPerSm": 6},
    "64 threads, 6 blocks/SM": {"kThreads": 64, "kBlocksPerSm": 6},
    "one tile buffer, 6 blocks/SM": {"buffers": 1, "kBlocksPerSm": 6},
}
STORE = "run[j] = (ok >> j) & 1 ? (int64_t)(canon ^ 0x8000000000000000ull) : INT64_MAX;"


def source(src: str, store_only=False, buffers=2, **consts) -> str:
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        chip_smoke.check(n == 1, f"{name} in extract.cu")
    if buffers == 1:
        for old, new in (("2 * kTile * 8;", "kTile * 8;"), ("buf ^= 1", "buf = 0"),
                         ("wait_group.read 1", "wait_group.read 0")):
            chip_smoke.check(old in src, f"{old!r} in extract.cu")
            src = src.replace(old, new)
    if store_only:
        chip_smoke.check(STORE in src, "the key store in extract.cu")
        src = src.replace(STORE, "run[j] = (int64_t)(p0 + j) + (int64_t)(canon & 0);")
    return src


def main() -> int:
    import numpy as np
    import torch

    from orion_kmer_tpu_torch import _kernels, codec
    from orion_kmer_tpu_torch.host import pack_for_transfer
    from orion_kmer_tpu_torch.ops import extract

    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_variants: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 1 << 24
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for p in rng.integers(0, n - 30, 2000):
        codes[p : p + int(rng.integers(1, 25))] = ord("N")
    lanes, inv = pack_for_transfer(codec.seq_to_codes(codes), n)
    L = torch.from_numpy(lanes.view(np.int32)).to(dev)
    I = torch.from_numpy(inv.view(np.int32)).to(dev)
    W = L.shape[0]
    exp_keys, exp_n = extract.extract_keys_plain(L, I, 31, n - 7)
    src = (ROOT / "orion_kmer_tpu_torch" / "csrc" / "extract.cu").read_text()
    stream = torch.cuda.current_stream().cuda_stream
    card = chip_smoke.gpu_name_and_limit()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edits) in enumerate(VARIANTS.items()):
            cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"libv{i}.so"
            cu.write_text(source(src, **edits))
            proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                                  capture_output=True, text=True)
            chip_smoke.check(proc.returncode == 0, f"{name} builds:\n{proc.stderr[-3000:]}")
            lib = ctypes.CDLL(str(so))
            for fn, (restype, argtypes) in _kernels._SIGNATURES.items():
                if fn.startswith("okt_extract"):
                    getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
            keys = torch.empty(16 * W, dtype=torch.int64, device=dev)
            block_valid = torch.empty(lib.okt_extract_blocks(W), dtype=torch.int32, device=dev)

            def run():
                return lib.okt_extract(L.data_ptr(), I.data_ptr(), W, 31, n - 7, keys.data_ptr(),
                                       block_valid.data_ptr(), stream)

            chip_smoke.check(run() == 0, f"{name} launches")
            torch.cuda.synchronize()
            exact = torch.equal(keys, exp_keys) and int(block_valid.sum()) == int(exp_n)
            chip_smoke.check(exact or edits.get("store_only", False), f"{name} == plain")
            regs = sorted({k["registers"] for k in _kernels.parse_ptxas(proc.stderr)})
            print(json.dumps({"variant": name, "ms": chip_smoke.median_ms(torch, run), "exact": exact,
                              "registers": regs, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
