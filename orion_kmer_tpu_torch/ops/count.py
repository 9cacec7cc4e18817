"""Deterministic k-mer counting on int64 keys: sort + merge + run-length
encode.

The torch counterparts of ``orion_kmer_tpu/ops/count.py``:
``sort_canonical_packed`` (extraction through K1, then ``torch.sort``),
``rle_sorted`` (``_rle_sorted`` / ``rle_compact``, head compaction
through K3) and ``combine_sorted_unique`` (run merge through K2, head
compaction through K3).  Counts are int64 throughout: the JAX (cnt_lo,
cnt_hi) u32 carry exists only because of TPU limits.

A raw run is (keys, n_valid): ascending keys whose first n_valid entries
are real windows and whose tail is SENTINEL_KEY, with n_valid a 0-d
device tensor, so the merge forest never waits on the device.
"""

from __future__ import annotations

import torch

from .compact import compact, compact_positions
from .extract import extract_keys
from .merge import merge


def _exact(t, m: int):
    """The first m entries of t, as their own tensor when t is longer (a
    view would keep a full-capacity buffer alive)."""
    return t if t.shape[0] == m else t[:m].clone()


def sort_canonical_packed(lanes, invalid_words, k: int, n_positions: int):
    """Extract + sort the canonical keys of a packed batch.  Returns a raw
    run (sorted keys of length 16 * len(lanes), n_valid)."""
    keys, n_valid = extract_keys(lanes, invalid_words, k, n_positions)
    return torch.sort(keys).values, n_valid


def merge_runs(a, b):
    """Merge two raw runs into one (duplicates ride along)."""
    keys, _ = merge(a[0], b[0])
    return keys, a[1] + b[1]


def rle_sorted(keys, n_valid):
    """Run-length encode a raw run.  Returns (unique keys, counts), int64
    tensors of exactly the unique count (one host sync).

    Heads before n_valid are compacted with their positions, which K3
    writes itself; a run's count is the next head's position minus its
    own (n_valid after the last head)."""
    is_head = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    torch.ne(keys[1:], keys[:-1], out=is_head[1:])
    (ukeys, upos), n_u = compact_positions(keys, is_head, n_valid)
    m = int(n_u)
    ukeys, upos = _exact(ukeys, m), upos[:m]
    nxt = torch.cat([upos[1:], n_valid.reshape(1).to(upos.dtype)])
    return ukeys, nxt - upos


def combine_sorted_unique(a_keys, a_cnt, b_keys, b_cnt):
    """Merge two sorted-unique counted tables, summing the counts of keys
    present in both.  Returns (keys, counts) of exactly the union's size
    (one host sync)."""
    keys, cnt = merge(a_keys, b_keys, a_cnt, b_cnt)
    if keys.shape[0] == 0:
        return keys, cnt
    # each key appears at most twice (both inputs are unique), a first
    eq_next = keys[1:] == keys[:-1]
    summed = cnt.clone()
    summed[:-1] += torch.where(eq_next, cnt[1:], 0)
    keep = torch.cat([eq_next.new_ones(1), ~eq_next])
    (ukeys, ucnt), n_u = compact([keys, summed], keep)
    m = int(n_u)
    return _exact(ukeys, m), _exact(ucnt, m)
