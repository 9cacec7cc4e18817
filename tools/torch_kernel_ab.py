#!/usr/bin/env python3
"""K1, K2, K3, K4 and the batch sort of two checkouts of the port, timed the same way on one card.

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
inputs.  Every K3 shape is held against its plain version first.  K2 at
``chip_smoke.k2_shapes``: the forest's keys-only merges at every level of a
flush (``chip_smoke.K2_FOREST``, 2^22 to 2^27 keys a side), the fold and a shard's fold (the merge with counts,
then the sums and keep flags: K2's fold mode, or, before it, the merge and
the torch chain ``combine_sorted_unique`` ran), the payload merge at the
fold's size, the whole ``combine_sorted_unique``, and the join's payload
merge.  The batch sort at count's 2^24 keys, of those k = 31 K1 keys on
62 bits and of full-range keys on 64: ``ops.radix.sort_keys`` where the
checkout has it, else its ``sort_keys``, held against
``torch.sort(x).values`` (the parent's call, ``library_ms``) and against
``cub::DeviceRadixSort::SortKeys`` over the same bits (``CUB_SORT``, which
this tool builds: ``cub_device_sort_ms``, with a copy of the input,
``clone_ms``, that keeps it), and beside its bound (16 B a key
a pass; and once); ``pass_ms`` is one onesweep launch by torch.profiler.  To compare
a commit with its parent, unpack the parent with ``git archive`` into a
directory that .gitignore lists and run parent, change, change, parent in
one call on the card.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# K3's kernels, as torch.profiler names them: the one-pass kernel, and the
# two of the version before it
K3_KERNELS = ("compact_kernel", "namespace)::count_kernel", "namespace)::scatter_kernel")
# K2's kernels: the one-launch kernel, and the two of the version before it
K2_KERNELS = ("merge_kernel", "merge_tile_kernel", "namespace)::partition_kernel")


def k2_rows(chip_smoke, torch, dev):
    """K2's shapes as its callers reach them: {shape: {ms, kernel_ms}}."""
    from orion_kmer_tpu_torch.ops import count, merge

    def chain(keys, cnt):  # the fold's epilogue as torch ops
        eq_next = keys[1:] == keys[:-1]
        summed = cnt.clone()
        summed[:-1] += torch.where(eq_next, cnt[1:], 0)
        return keys, summed, torch.cat([eq_next.new_ones(1), ~eq_next])

    def fold(a, b, ca, cb):
        if hasattr(merge, "merge_combine"):
            return merge.merge_combine(a, b, ca, cb)
        return chain(*merge.merge(a, b, ca, cb))

    def timed(fn, want):
        got = fn()
        chip_smoke.check(all(torch.equal(g, w) for g, w in zip(got, want)), "K2 == plain")
        alone = [chip_smoke.kernel_ms(torch, fn, name) for name in K2_KERNELS]
        return {"ms": chip_smoke.median_ms(torch, fn), "kernel_ms": sum(t for t in alone if t is not None)}

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    out = {}
    for what, mode, (a, b, pa, pb), _ in chip_smoke.k2_shapes(torch, dev, gen):
        if mode == "keys":
            out[f"K2 {what}"] = timed(lambda: merge.merge(a, b)[:1], merge.merge_plain(a, b)[:1])
        elif mode == "payload":
            out[f"K2 {what}"] = timed(lambda: merge.merge(a, b, pa, pb), merge.merge_plain(a, b, pa, pb))
        else:
            want = chain(*merge.merge_plain(a, b, pa, pb))
            out[f"K2 {what}"] = timed(lambda: fold(a, b, pa, pb), want)
            out[f"K2 payload merge, {what.split(', ', 1)[1]}"] = timed(
                lambda: merge.merge(a, b, pa, pb), merge.merge_plain(a, b, pa, pb))
            keys, summed, keep = want
            whole = (keys[keep], summed[keep])
            out[f"combine_sorted_unique, {what.split(', ', 1)[1]}"] = {"ms": chip_smoke.median_ms(
                torch, lambda: count.combine_sorted_unique(a, pa, b, pb), calls=5)}
            chip_smoke.check(all(torch.equal(g, w) for g, w in zip(count.combine_sorted_unique(a, pa, b, pb), whole)),
                             "combine_sorted_unique == plain")
    return out


# cub::DeviceRadixSort::SortKeys, keys only over bits [0, end_bit): the
# library's whole device sort, timed beside the batch sort as the simple
# design's reference; built by this tool, not part of the package
CUB_SORT = r"""
#include <cstdint>
#include <cub/device/device_radix_sort.cuh>

extern "C" int64_t ab_cub_temp(int64_t n, int end_bit) {
  size_t bytes = 0;
  cub::DoubleBuffer<int64_t> d(nullptr, nullptr);
  return cub::DeviceRadixSort::SortKeys(nullptr, bytes, d, (int)n, 0, end_bit) == cudaSuccess ? (int64_t)bytes : -1;
}

// a, b: the double buffer (the keys in a); *selector: which holds the result
extern "C" int ab_cub_sort(void* temp, int64_t bytes, void* a, void* b, int64_t n, int end_bit, void* stream,
                           int* selector) {
  size_t t = (size_t)bytes;
  cub::DoubleBuffer<int64_t> d((int64_t*)a, (int64_t*)b);
  cudaError_t err = cub::DeviceRadixSort::SortKeys(temp, t, d, (int)n, 0, end_bit, (cudaStream_t)stream);
  *selector = d.selector;
  return (int)err;
}
"""


def build_cub_sort(out_dir: Path):
    """nvcc of CUB_SORT, started: (the library's path, the process)."""
    import subprocess

    from orion_kmer_tpu_torch import _kernels

    cu, so = out_dir / "cub_sort.cu", out_dir / "cub_sort.so"
    cu.write_text(CUB_SORT)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cub_sorter(chip_smoke, torch, so: Path, proc):
    """The built CUB_SORT as fn(keys, end_bit) -> sorted keys."""
    import ctypes

    _, err = proc.communicate()
    chip_smoke.check(proc.returncode == 0, f"nvcc of the CUB reference:\n{err}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.ab_cub_temp.restype, lib.ab_cub_temp.argtypes = I, [I, ctypes.c_int]
    lib.ab_cub_sort.restype = ctypes.c_int
    lib.ab_cub_sort.argtypes = [P, I, P, P, I, ctypes.c_int, P, ctypes.POINTER(ctypes.c_int)]

    def sort(keys, end_bit):
        n = keys.shape[0]
        bytes_ = lib.ab_cub_temp(n, end_bit)
        temp = torch.empty(max(bytes_, 1), dtype=torch.uint8, device=keys.device)
        bufs = (keys.clone(), torch.empty_like(keys))  # the clone, as the port's sort keeps its input
        selector = ctypes.c_int(0)
        rc = lib.ab_cub_sort(temp.data_ptr(), bytes_, bufs[0].data_ptr(), bufs[1].data_ptr(), n, end_bit,
                             torch.cuda.current_stream(keys.device).cuda_stream, ctypes.byref(selector))
        chip_smoke.check(rc == 0, f"cub::DeviceRadixSort::SortKeys: CUDA error {rc}")
        return bufs[selector.value]

    return sort


def sort_rows(chip_smoke, torch, dev, k31_keys, cub_sort):
    """The batch sort at count's batch size: {shape: {...}}."""
    from orion_kmer_tpu_torch.ops import sort

    try:
        from orion_kmer_tpu_torch.ops import radix
    except ImportError:  # a checkout before the radix sort
        radix = None
    n = k31_keys.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    full = torch.randint(-(2**63), 2**63 - 1, (n,), device=dev, generator=gen)
    out = {}
    for what, keys, key_bits in (("k=31 K1 keys, 62 bits", k31_keys, 62), ("full range, 64 bits", full, 64)):
        want = torch.sort(keys).values
        lib_fn = lambda: cub_sort(keys, key_bits)  # noqa: E731
        chip_smoke.check(torch.equal(lib_fn(), want), "cub::DeviceRadixSort::SortKeys == torch.sort")
        row = {"library_ms": chip_smoke.median_ms(torch, lambda: torch.sort(keys).values),
               "library_pass_ms": chip_smoke.kernel_ms(torch, lambda: torch.sort(keys), "RadixSortOnesweep"),
               "cub_device_sort_ms": chip_smoke.median_ms(torch, lib_fn),
               "cub_device_pass_ms": chip_smoke.kernel_ms(torch, lib_fn, "RadixSortOnesweep"),
               "clone_ms": chip_smoke.median_ms(torch, keys.clone),  # in cub_device_sort_ms
               "bound_ms_once": chip_smoke.bound_ms(16 * n)}
        if radix is None:
            chip_smoke.check(torch.equal(sort.sort_keys(keys), want), "sort_keys == torch.sort")
            row["sort_keys_ms"] = chip_smoke.median_ms(torch, lambda: sort.sort_keys(keys))
        else:
            fn = lambda: radix.sort_keys(keys, key_bits)  # noqa: E731
            chip_smoke.check(torch.equal(fn(), want), "radix sort == torch.sort")
            passes = radix.passes(key_bits)
            row.update(passes=passes, ms=chip_smoke.median_ms(torch, fn),
                       pass_ms=chip_smoke.kernel_ms(torch, fn, "radix_onesweep"),
                       bound_ms=chip_smoke.bound_ms(16 * passes * n))
        out[f"batch sort 2^24, {what}"] = row
    return out


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
    tmp = tempfile.TemporaryDirectory()
    cub_build = build_cub_sort(Path(tmp.name))  # nvcc runs while K1 and K4 are timed
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
    out.update(sort_rows(chip_smoke, torch, dev, got[0], cub_sorter(chip_smoke, torch, *cub_build)))
    del L, I, got, exp
    out.update(k2_rows(chip_smoke, torch, dev))
    torch.cuda.empty_cache()
    out.update(k3_rows(chip_smoke, torch, dev))
    print(json.dumps(out))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
