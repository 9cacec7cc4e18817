"""FracMinHash sketching of a packed batch on the device, and the host
estimators.

The torch counterpart of ``orion_kmer_tpu/ops/sketch.py``.  A k-mer is
kept iff splitmix64(canonical k-mer) < 2^64 / scaled.  A batch goes
through K1 (``extract_keys``), the hash and keep chain (torch ops), K3
(``compact``) of the survivors, ``radix.sort_keys`` of the n_kept survivors
only, and ``count.rle_sorted`` (K3 again) for the abundances.

The JAX sparse capacity, its ``overflow`` flag and the dense retry exist
because XLA needs static shapes; K3 returns the exact survivor count, so
here every batch is exact in one pass, duplicate-heavy input included.

Validity at every k, k = 32 included: K1 writes SENTINEL_KEY (u64
all-ones) for an invalid window, and no canonical k-mer has that value.
A canonical key is min(fwd, rc); fwd = all-ones is T^k, whose rc is A^k
= 0, so the minimum is 0.  ``key != SENTINEL_KEY`` is therefore exact
validity, and a genuine T^32 window (canonical A^32) is kept as a valid
window.

``sketch_compare``, ``pairwise_intersections`` and the oracle
``sketch_np`` are numpy, copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..keys import SENTINEL_KEY
from .compact import compact
from .count import rle_sorted
from .extract import extract_keys
from .hash import SIGN, splitmix64, splitmix64_np
from .radix import sort_keys


def scaled_threshold(scaled: int) -> int:
    """floor(2^64 / scaled): a hash below it is kept."""
    if scaled < 1:
        raise ValueError(f"scaled must be >= 1, got {scaled}")
    return (1 << 64) // scaled


def keep_mask(keys: torch.Tensor, hashes: torch.Tensor, scaled: int) -> torch.Tensor:
    """Windows to keep: valid, and hash < 2^64 / scaled.  ``hashes`` are
    splitmix64 of ``keys``, flipped, so the u64 threshold becomes a signed
    compare against threshold - 2^63 (which fits int64 for scaled >= 2).
    With scaled == 1 every valid window is kept: 2^64 fits no int64."""
    thr = scaled_threshold(scaled)
    valid = keys != SENTINEL_KEY
    if scaled == 1:
        return valid
    return valid & (hashes < thr + SIGN)


def sketch_packed(lanes, invalid_words, k: int, n_positions: int, scaled: int):
    """FracMinHash of one packed batch: (hashes, counts), the sorted unique
    kept hashes as flipped int64 and their abundances as int64, both of
    exactly the unique count, on the batch's device (one host sync)."""
    keys, _ = extract_keys(lanes, invalid_words, k, n_positions)
    hashes = splitmix64(keys)
    (kept,), n_kept = compact([hashes], keep_mask(keys, hashes, scaled))
    m = int(n_kept)
    if m == 0:
        return kept.new_empty(0), kept.new_empty(0)
    return rle_sorted(sort_keys(kept[:m]), n_kept)  # 64-bit hashes: every bit


def sketch_compare(a: np.ndarray, b: np.ndarray) -> dict:
    """Jaccard/containment estimates between two sorted hash sets.

    FracMinHash estimators: since both sketches subsample the SAME hash
    space fraction, plain set Jaccard/containment over the sketch hashes
    estimates the genome-level values.
    """
    inter = np.intersect1d(a, b).shape[0]
    union = a.shape[0] + b.shape[0] - inter
    return {
        "intersection": int(inter),
        "union": int(union),
        "jaccard": (inter / union) if union else 0.0,
        "containment_a_in_b": (inter / a.shape[0]) if a.shape[0] else 0.0,
        "containment_b_in_a": (inter / b.shape[0]) if b.shape[0] else 0.0,
    }


def pairwise_intersections(sketch_hashes: list) -> np.ndarray:
    """All-pairs intersection sizes over P sorted-unique hash sets in
    ONE sort of the concatenation: O(total log total + sum_h C(m_h, 2))
    where m_h = #sketches containing hash h -- output-sized work.

    Each hash h present in m sketches contributes one count to each of
    its C(m, 2) sketch pairs: sort (hash, sketch_id) pairs, rank
    elements within equal-hash groups, and for stride d = 1..max_rank
    pair every element with the element d before it in its group --
    exactly the C(m, 2) enumeration, vectorized per stride.

    Returns int64 [P, P], symmetric with diagonal = sketch sizes.
    """
    P = len(sketch_hashes)
    mat = np.zeros((P, P), dtype=np.int64)
    if P == 0:
        return mat
    arrs = [np.asarray(h, dtype=np.uint64) for h in sketch_hashes]
    sizes = np.array([a.shape[0] for a in arrs], dtype=np.int64)
    np.fill_diagonal(mat, sizes)
    n = int(sizes.sum())
    if n == 0:
        return mat
    allh = np.concatenate(arrs)
    ids = np.repeat(np.arange(P, dtype=np.int32), sizes)
    order = np.argsort(allh, kind="stable")
    sh = allh[order]
    sid = ids[order]
    head = np.empty(n, dtype=bool)
    head[0] = True
    np.not_equal(sh[1:], sh[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    gidx = np.cumsum(head) - 1
    rank = np.arange(n, dtype=np.int64) - starts[gidx]
    max_rank = int(rank.max())
    # Elements with rank >= d form a suffix of a rank-stable-sorted index
    # array, so each stride slices a shrinking suffix (total work = the
    # number of pairs emitted) instead of rescanning all n elements per d.
    by_rank = np.argsort(rank, kind="stable")
    sorted_rank = rank[by_rank]
    for d in range(1, max_rank + 1):
        i = by_rank[np.searchsorted(sorted_rank, d, side="left") :]
        a = sid[i - d]
        b = sid[i]
        np.add.at(mat, (np.minimum(a, b), np.maximum(a, b)), 1)
    # mirror the upper triangle (diagonal already holds sizes)
    low = np.tril_indices(P, -1)
    mat[low] = mat.T[low]
    return mat


def sketch_np(vals: np.ndarray, scaled: int) -> np.ndarray:
    """Host oracle: FracMinHash of uint64 canonical k-mers."""
    h = splitmix64_np(np.unique(vals))
    thr = np.uint64((1 << 64) // scaled)
    return np.unique(h[h < thr])
