#!/usr/bin/env python3
"""K1 and K4 of two checkouts of the port, timed the same way on one card.

    python3 tools/torch_kernel_ab.py [--root DIR]

Times ``extract_keys`` (2^24 positions with N runs, k = 31) and
``sort_pairs`` (2^14 and 12,289 keys) of the ``orion_kmer_tpu_torch``
package under DIR (default: this checkout) with ``chip_smoke.py``'s
``median_ms`` (device time of back-to-back calls) and ``kernel_ms`` (the
kernel alone, by torch.profiler), after checking each against its plain
version.  To compare a commit with its parent, unpack the parent with
``git archive`` into a directory that .gitignore lists and run
parent, change, change, parent in one call on the card.  Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke  # the timers of this checkout

    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from orion_kmer_tpu_torch import codec
    from orion_kmer_tpu_torch.host import pack_for_transfer
    from orion_kmer_tpu_torch.ops import extract, sort

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    chip_smoke.check(Path(extract.__file__).is_relative_to(root), f"the package of {root} is timed")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 1 << 24
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for p in rng.integers(0, n - 30, 2000):
        codes[p : p + int(rng.integers(1, 25))] = ord("N")
    lanes, inv = pack_for_transfer(codec.seq_to_codes(codes), n)
    L = torch.from_numpy(lanes.view(np.int32)).to(dev)
    I = torch.from_numpy(inv.view(np.int32)).to(dev)
    got, exp = extract.extract_keys(L, I, 31, n - 7), extract.extract_keys_plain(L, I, 31, n - 7)
    chip_smoke.check(torch.equal(got[0], exp[0]) and int(got[1]) == int(exp[1]), "K1 == plain")
    out = {"root": str(root), "card": chip_smoke.gpu_name_and_limit()}
    fn = lambda: extract.extract_keys(L, I, 31, n - 7)  # noqa: E731
    out["K1 k=31 2^24"] = {"ms": chip_smoke.median_ms(torch, fn),
                           "kernel_ms": chip_smoke.kernel_ms(torch, fn, "extract_kernel")}
    for m in (1 << 14, 12289):
        keys = torch.randint(-(1 << 62), 1 << 62, (m,), device=dev)
        chip_smoke.check(torch.equal(sort.sort_pairs(keys), torch.sort(keys).values), "K4 == plain")
        fn = lambda: sort.sort_pairs(keys)  # noqa: E731
        out[f"K4 {m}"] = {"ms": chip_smoke.median_ms(torch, fn),
                          "kernel_ms": chip_smoke.kernel_ms(torch, fn, "sort_kernel"),
                          "torch.sort ms": chip_smoke.median_ms(torch, lambda: torch.sort(keys))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
