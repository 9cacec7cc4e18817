"""Plain reference of ``count -k K -m M --histogram`` over a FASTQ of
fixed-width reads: every valid window's canonical value counted, the
``KMER\\tCOUNT`` rows of counts >= M in ascending order, and the histogram
of every count; each as its tree digest.  The control keys the k-mers by
a 40-bit hash, as an approximate counter would."""

from __future__ import annotations

import torch

from ..harness.digest import tree_digest
from . import kmers


def table(reads_path, read_len: int, head_w: int, k: int, device, block_rows: int = 1 << 20):
    """(ascending canonical values, counts) of every valid window of the
    reads, on ``device``; read from the file in blocks of rows."""
    rows = kmers.fastq_rows(reads_path, read_len, head_w)
    lut = torch.from_numpy(kmers.code_table(normalize=True)).to(device)
    runs = []
    for lo in range(0, rows.shape[0], block_rows):
        seq = torch.from_numpy(rows[lo : lo + block_rows, head_w : head_w + read_len].copy()).to(device)
        keys, valid = kmers.window_keys(lut[seq.long()], k)
        runs.append(kmers.counted(keys[valid]))
        del seq, keys, valid
    return kmers.count_runs(runs)


def outputs(vals, counts, k: int, min_count: int, pool) -> dict:
    """The digests of the TSV and the histogram of a counted table."""
    keep = counts >= min_count
    tsv = kmers.render_tsv(vals[keep], counts[keep], k)
    return {
        "tsv": tree_digest(tsv, pool),
        "histogram": tree_digest(kmers.histogram_bytes(counts), pool),
        "rows": int(keep.sum()),
        "distinct": int(vals.shape[0]),
    }


def expected(reads_path, read_len, head_w, k, min_count, device, pool) -> dict:
    return outputs(*table(reads_path, read_len, head_w, k, device), k, min_count, pool)


def control(reads_path, read_len, head_w, k, min_count, device, pool) -> dict:
    vals, counts = table(reads_path, read_len, head_w, k, device)
    return outputs(*kmers.narrowed(vals, counts), k, min_count, pool)
