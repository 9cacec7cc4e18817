#!/usr/bin/env python3
"""Device time of each step of one `query` batch on one card.

    python3 tools/torch_query_stages.py [--seed N] [--calls C] [--reps R]

Makes the DB of ``chip_smoke.py`` phase 6 (the sorted unique 31-mers of
its three references: a 4.64 Mbp genome, a copy with 1 % substitutions
and an unrelated 5 Mbp genome) and one batch of 2^24 positions laid out
as the native parser lays out phase 5's reads (150 bp from both strands
of the genome, 0.2 % substitutions, each followed by k - 1 invalid
positions), stages it on the card and times, with
``chip_smoke.median_ms``, every step of ``engine._batch_hits``: K1
(``extract_keys``), the sort of the batch's keys, K2's join
(``merge`` with the positions as payload), the member flags of the
merged rows (``setops._merged`` after the merge; and, beside it, the
same flags from a forward ``torch.cummax`` over the run heads, the way
they were found before), the scatter of the flags back to positions
(one spare slot for every row that must not land, and spread over 4096
spare slots), the per-record sums, and the whole ``_batch_hits``.  Every
variant is checked against the step it stands beside.  Prints one JSON
line with the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K = 31
READ_LEN = 150
BATCH = 1 << 24


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=5, help="calls a rep")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke
    from orion_kmer_tpu_torch import codec, engine, staging
    from orion_kmer_tpu_torch.ops import setops
    from orion_kmer_tpu_torch.ops.extract import extract_keys
    from orion_kmer_tpu_torch.ops.merge import merge

    chip_smoke.check(torch.cuda.is_available(), "a CUDA card is visible")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    genome = rng.integers(0, 4, 4_641_652).astype(np.uint8)
    g_b = genome.copy()
    subs = rng.random(g_b.shape[0]) < 0.01
    g_b[subs] = (g_b[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    g_c = rng.integers(0, 4, 5_000_000).astype(np.uint8)
    db_vals = np.unique(np.concatenate([codec.extract_kmers_np(g, K) for g in (genome, g_b, g_c)]))

    row = READ_LEN + K - 1
    m = -(-BATCH // row)
    starts = rng.integers(0, genome.shape[0] - READ_LEN, m)
    reads = genome[starts[:, None] + np.arange(READ_LEN)]
    rev = rng.random(m) < 0.5
    reads[rev] = 3 - reads[rev][:, ::-1]
    err = rng.random(reads.shape) < 0.002
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()))) % 4
    rows = np.full((m, row), codec.INVALID_CODE, np.uint8)
    rows[:, :READ_LEN] = reads
    piece = rows.ravel()[:BATCH]
    ring = staging.PinnedRing(dev)
    lanes, inv, size, n, rec_starts = staging.stage_query(ring, piece, np.arange(m, dtype=np.int64) * row)
    db_keys = engine._db_on_device(db_vals, dev)

    keys, n_valid = extract_keys(lanes, inv, K, n)
    skeys, order = torch.sort(keys)
    valid = torch.arange(size, device=dev) < n_valid
    q_tags = torch.where(valid, order, size)
    db_tags = -1 - torch.arange(db_keys.shape[0], device=dev)
    mkeys, mtags = merge(db_keys, skeys, db_tags, q_tags, caller="join")
    idx = torch.arange(mkeys.shape[0], device=dev)

    def hit_by_cummax():
        is_db = mtags < 0
        is_head = torch.ones_like(is_db)
        is_head[1:] = mkeys[1:] != mkeys[:-1]
        head = torch.cummax(torch.where(is_head, idx, 0), 0).values
        return ~is_db & is_db[head]

    def hit_as_merged():
        return setops._member_rows(db_keys, mkeys, mtags)

    hit = hit_as_merged()
    chip_smoke.check(torch.equal(hit, hit_by_cummax()), "member flags == the cummax run heads'")

    def scatter_spread():
        out = torch.zeros(size + 4096, dtype=torch.bool, device=dev)
        out[torch.where(hit, mtags, size + (idx & 4095))] = True
        return out[:size]

    member = setops._scatter_true(mtags, hit, size)
    chip_smoke.check(torch.equal(member, scatter_spread()), "scatter, spread == one spare slot")

    def record_sums():
        prefix = torch.zeros(size + 1, dtype=torch.int64, device=dev)
        torch.cumsum(member, 0, out=prefix[1:])
        hi = torch.cat([rec_starts[1:], rec_starts.new_full((1,), size)])
        return prefix[hi] - prefix[rec_starts]

    chip_smoke.check(
        torch.equal(record_sums(), engine._batch_hits(lanes, inv, size, n, rec_starts, db_keys, K)),
        "the steps == _batch_hits",
    )
    steps = {
        "K1 extract_keys": lambda: extract_keys(lanes, inv, K, n),
        "sort of the batch": lambda: torch.sort(keys),
        "K2 join (merge with payload)": lambda: merge(db_keys, skeys, db_tags, q_tags, caller="join"),
        "member flags (setops)": hit_as_merged,
        "member flags by cummax": hit_by_cummax,
        "scatter, one spare slot (setops)": lambda: setops._scatter_true(mtags, hit, size),
        "scatter, 4096 spare slots": scatter_spread,
        "record sums": record_sums,
        "_batch_hits": lambda: engine._batch_hits(lanes, inv, size, n, rec_starts, db_keys, K),
    }
    ms = {name: chip_smoke.median_ms(torch, fn, args.calls, args.reps) for name, fn in steps.items()}
    print(json.dumps({"card": chip_smoke.gpu_name_and_limit(), "db_keys": int(db_keys.shape[0]),
                      "batch_positions": n, "records": m, "valid_windows": int(n_valid),
                      "members": int(member.sum()), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
