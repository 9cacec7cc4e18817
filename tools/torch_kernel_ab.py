#!/usr/bin/env python3
"""K1, K3 and K4 of two checkouts of the port, timed the same way on one card.

    python3 tools/torch_kernel_ab.py [--root DIR]

Times ``extract_keys`` (2^24 positions with N runs, k = 31) and
``sort_pairs`` (2^14 and 12,289 keys) of the ``orion_kmer_tpu_torch``
package under DIR (default: this checkout) with ``chip_smoke.py``'s
``median_ms`` (device time of back-to-back calls) and ``kernel_ms`` (the
kernel alone, by torch.profiler), after checking each against its plain
version.  K3 at every shape the main path gives it, through the calls the
callers make, so that a checkout without a mode is timed as its callers
did it: two planes at 2^25 (densities 0.03, 0.5, 0.97), one plane at 2^24
and density 1/1000 (the sketch), one plane at 2^25 and density 0.5
(``membership_sorted``), positions at 2^25 and density 0.1 with a limit
(the size stand-in of the flush's ``rle_sorted``; before the positions
mode, a compaction of the keys and an ``arange`` built by the caller), at
2^28 over the heads of a sorted run (the flush's own size) and at 2^24
and density 0.97 (``membership``), two planes at the fold's 49 M elements
and density 0.97, and the route of a 2^22-key block four and eight ways
(``ops.compact.partition``; before it, ``sharded.route_keys``); then
``rle_sorted`` of that 2^28-key run, the flush, against
``torch.unique_consecutive``, with its peak device memory above its
inputs.  Every K3 shape is held against its plain version first.  To compare
a commit with its parent, unpack the parent with ``git archive`` into a
directory that .gitignore lists and run parent, change, change, parent in
one call on the card.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# K3's kernels, as torch.profiler names them: the one-pass kernel, and the
# two of the version before it
K3_KERNELS = ("compact_kernel", "namespace)::count_kernel", "namespace)::scatter_kernel")


def k3_rows(chip_smoke, torch, dev):
    """K3's shapes as its callers reach them: {shape: {ms, kernel_ms}}."""
    from orion_kmer_tpu_torch.keys import SENTINEL_KEY
    from orion_kmer_tpu_torch.ops import compact, count
    from orion_kmer_tpu_torch.ops import hash as hash_ops
    from orion_kmer_tpu_torch.parallel import sharded

    # the route and the owner of a key, as this checkout names them
    route = getattr(compact, "partition", None) or sharded.route_keys
    owner_of = getattr(hash_ops, "owner_of", None) or sharded.owner_of

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def positions(keys, keep, limit=None):
        if hasattr(compact, "compact_positions"):
            return compact.compact_positions(keys, keep, limit)
        idx = torch.arange(keys.shape[0], device=keys.device)  # what the callers built before
        return compact.compact([keys, idx], keep if limit is None else keep & (idx < limit))

    def timed(fn, check):
        chip_smoke.check(check(), "K3 == plain")
        alone = [chip_smoke.kernel_ms(torch, fn, name) for name in K3_KERNELS]
        return {"ms": chip_smoke.median_ms(torch, fn), "kernel_ms": sum(t for t in alone if t is not None)}

    def same(got, want):
        (outs, n), (pouts, pn) = got, want
        m = int(n)
        return m == int(pn) and all(torch.equal(o[:m], p) for o, p in zip(outs, pouts))

    out = {}
    n = 1 << 25
    x0 = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev, generator=gen)
    x1 = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev, generator=gen)
    for density in (0.03, 0.5, 0.97):
        keep = torch.rand(n, device=dev, generator=gen) < density
        out[f"K3 two planes 2^25 d={density}"] = timed(
            lambda: compact.compact([x0, x1], keep),
            lambda: same(compact.compact([x0, x1], keep), compact.compact_plain([x0, x1], keep)))
    keep = torch.rand(n, device=dev, generator=gen) < 0.5
    out["K3 one plane 2^25 d=0.5"] = timed(
        lambda: compact.compact([x0], keep), lambda: same(compact.compact([x0], keep), compact.compact_plain([x0], keep)))
    keep = torch.rand(n, device=dev, generator=gen) < 0.1
    lim = torch.tensor(n - 1000, device=dev)
    idx = torch.arange(n, device=dev)
    want = compact.compact_plain([x0, idx], keep & (idx < lim))
    out["K3 positions 2^25 d=0.1 limit"] = timed(lambda: positions(x0, keep, lim), lambda: same(positions(x0, keep, lim), want))
    del idx, want
    run, heads, n_valid = chip_smoke.k3_flush_run(torch, dev, gen)
    n = run.shape[0]
    idx = torch.arange(n, device=dev)
    want = compact.compact_plain([run, idx], heads & (idx < n_valid))
    out["K3 positions 2^28 flush heads limit"] = timed(
        lambda: positions(run, heads, n_valid), lambda: same(positions(run, heads, n_valid), want))
    del run, heads, idx, want
    n = chip_smoke.K3_FOLD
    f0 = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev, generator=gen)
    f1 = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev, generator=gen)
    keep = torch.rand(n, device=dev, generator=gen) < 0.97
    out[f"K3 two planes {n} d=0.97"] = timed(
        lambda: compact.compact([f0, f1], keep),
        lambda: same(compact.compact([f0, f1], keep), compact.compact_plain([f0, f1], keep)))
    del f0, f1
    n = 1 << 24
    idx = torch.arange(n, device=dev)
    q, keep = x0[:n], torch.rand(n, device=dev, generator=gen) < 0.97
    want = compact.compact_plain([q, idx[:n]], keep)
    out["K3 positions 2^24 d=0.97"] = timed(lambda: positions(q, keep), lambda: same(positions(q, keep), want))
    keep = torch.rand(n, device=dev, generator=gen) < 1e-3
    out["K3 one plane 2^24 d=1/1000"] = timed(
        lambda: compact.compact([q], keep), lambda: same(compact.compact([q], keep), compact.compact_plain([q], keep)))
    del x0, x1, q, keep, idx, want

    n = 1 << 22
    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), device=dev, generator=gen)
    keys[torch.rand(n, device=dev, generator=gen) < 0.05] = SENTINEL_KEY
    valid = keys != SENTINEL_KEY
    for n_dest in (4, 8):
        owner = owner_of(keys, n_dest)
        segs = sharded.route_to_owners(keys, n_dest)
        ok = lambda: all(torch.equal(s, keys[valid & (owner == d)]) for d, s in enumerate(segs))  # noqa: E731
        out[f"K3 route 2^22 S={n_dest}"] = timed(lambda: route(keys, n_dest), ok)
    del keys, valid, owner, segs

    # the flush: rle_sorted of a sorted 2^28-key run with ~10 % heads and
    # a sentinel tail; its peak above its inputs
    run, heads, n_valid = chip_smoke.k3_flush_run(torch, dev, gen)
    del heads
    n = run.shape[0]
    wkeys, wcnt = torch.unique_consecutive(run[: n - chip_smoke.K3_FLUSH_TAIL], return_counts=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ukeys, ucnt = count.rle_sorted(run, n_valid)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    chip_smoke.check(torch.equal(ukeys, wkeys) and torch.equal(ucnt, wcnt), "rle_sorted == torch.unique_consecutive")
    del ukeys, ucnt, wkeys, wcnt
    out["rle_sorted 2^28 (flush)"] = {"ms": chip_smoke.median_ms(torch, lambda: count.rle_sorted(run, n_valid), calls=3, reps=5),
                                      "peak_gib_above_inputs": peak / 2**30}
    return out


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
    del L, I, got, exp
    out.update(k3_rows(chip_smoke, torch, dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
