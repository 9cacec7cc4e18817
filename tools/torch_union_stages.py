#!/usr/bin/env python3
"""Time each step of a k-mer database's union on one card, beside numpy's.

    python3 tools/torch_union_stages.py [--sets 50] [--keys 5000000] [--seed N] [--reps 3] [--device cuda]

Makes ``--sets`` sorted unique sets of about ``--keys`` 31-mer values in
five clades, each set its clade's ancestor with 0.1-5 % of its keys
replaced (log-spaced, as ``h100bench``'s ``clades`` generator mutates its
genomes), and times with the host clock, each step ended by a
synchronisation, the median of ``--reps``:

- numpy's union (``KmerDb.get_all_kmers_unified()``, once);
- on the card, ``total_unique_kmers(device)`` and
  ``get_all_kmers_unified(device)`` whole, with their peak device memory;
- their steps: the upload of the sets into one buffer (pageable, as
  ``setops._sets_on_device`` makes it, and through one pinned staging
  buffer, its allocation counted and not), the sign flip, the K2 forest
  (``setops.union_runs``), the heads' count, K3's compaction, and the
  fetch (into pinned memory, as ``setops.union_of_sets`` does it, and
  pageable).

Every card result is checked against numpy's.  Prints one JSON line with
the card's name and power limit.  ``--device cpu`` rehearses the steps on
the CPU at a small size (their times are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def clade_sets(rng, n_sets: int, n_keys: int, clades: int = 5):
    """Sorted unique u64 sets: each clade's ancestor with a log-spaced
    share of its keys replaced by fresh ones."""
    import numpy as np

    from orion_kmer_tpu_torch.db import sorted_unique

    rates = np.geomspace(0.001, 0.05, max(1, n_sets // clades))
    ancestors = [sorted_unique(rng.integers(0, 1 << 62, n_keys, dtype=np.uint64)) for _ in range(clades)]
    sets = []
    for i in range(n_sets):
        anc = ancestors[i % clades]
        rate = rates[(i // clades) % rates.shape[0]]
        keep = rng.random(anc.shape[0]) >= rate
        fresh = np.sort(rng.integers(0, 1 << 62, int(anc.shape[0] - keep.sum()), dtype=np.uint64))
        sets.append(sorted_unique(np.concatenate([anc[keep], fresh])))
    return sets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", type=int, default=50)
    ap.add_argument("--keys", type=int, default=5_000_000)
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import numpy as np
    import torch

    from orion_kmer_tpu_torch.db import KmerDb
    from orion_kmer_tpu_torch.keys import flip
    from orion_kmer_tpu_torch.ops import merge, setops
    from orion_kmer_tpu_torch.ops.compact import compact
    from orion_kmer_tpu_torch.staging import to_host

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timed(fn, reps=args.reps, prepare=None):
        """(median seconds, the last result) of ``fn(prepare())``."""
        times, out = [], None
        for _ in range(reps):
            arg = prepare() if prepare else None
            sync()
            t0 = time.perf_counter()
            out = fn(arg) if prepare else fn()
            sync()
            times.append(time.perf_counter() - t0)
            del arg
        return statistics.median(times), out

    t0 = time.perf_counter()
    sets = clade_sets(np.random.default_rng(args.seed), args.sets, args.keys)
    n = sum(s.shape[0] for s in sets)
    db = KmerDb(k=31, references={f"g{i}": s for i, s in enumerate(sets)})
    out = {"sets": args.sets, "keys": n, "made_s": time.perf_counter() - t0}
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True)
        out["card"] = smi.stdout.strip()

    t_np, exp = timed(db.get_all_kmers_unified, reps=1)
    out["numpy_union_s"] = t_np
    out["union_keys"] = int(exp.shape[0])

    def peak(fn):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t, res = timed(fn)
        return t, res, (torch.cuda.max_memory_allocated(dev) if on_card else None)

    before = merge.by_caller.get("union", 0)
    out["count_s"], got_n, out["count_peak_bytes"] = peak(lambda: db.total_unique_kmers(dev))
    out["fetch_s"], got, out["fetch_peak_bytes"] = peak(lambda: db.get_all_kmers_unified(dev))
    assert got_n == exp.shape[0] and np.array_equal(got, exp), "the card's union differs from numpy's"
    out["union_launches_a_union"] = (merge.by_caller.get("union", 0) - before) / (2 * args.reps)

    # the steps one by one
    out["upload_pageable_s"], buf = timed(lambda: setops._sets_on_device(sets, dev))

    def staged():
        host = torch.empty(n + len(sets), dtype=torch.int64, pin_memory=on_card)
        np.concatenate(sets, out=host.numpy()[:n].view(np.uint64))
        return host

    def via_staging(host):
        d = torch.empty_like(host, device=dev)
        d.copy_(host, non_blocking=True)
        flip(d[:n], out=d[:n])
        return d

    out["upload_pinned_with_alloc_s"], _ = timed(lambda: via_staging(staged()))
    host = staged()
    out["upload_pinned_reused_s"], _ = timed(lambda: via_staging(host))
    del host, _
    out["flip_s"], _ = timed(lambda: flip(buf[:n], out=buf[:n]), reps=2 * args.reps)
    lengths = [s.shape[0] for s in sets]
    out["forest_s"], (keys, heads) = timed(lambda b: setops.union_runs(b, lengths), prepare=buf.clone)
    del buf
    out["heads_count_s"], m = timed(lambda: int(heads.sum()))
    out["compact_s"], ((ukeys,), n_u) = timed(lambda: compact([keys], heads))
    assert int(n_u) == m == exp.shape[0]
    ukeys = flip(ukeys[:m], out=ukeys[:m])
    if on_card:
        out["fetch_pinned_s"], (fetched,) = timed(lambda: to_host(ukeys))
        out["fetch_pageable_s"], _ = timed(lambda: ukeys.cpu())
    else:
        fetched = ukeys.numpy()
    assert np.array_equal(fetched.view(np.uint64), exp), "the steps' union differs from numpy's"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
