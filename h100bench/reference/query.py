"""Plain reference of ``query -d DB -r READS -c C``: a read's hits are its
windows, read as raw bytes, whose canonical value is in the union of the
database's sets, each window counted; the output is the id of every read
of at least k bases with at least C hits, one per line, in input order.
The control counts hits on a 1-in-10 hash sample of the windows and
scales by 10, as a sketch-based screen would."""

from __future__ import annotations

import numpy as np
import torch

from ..harness.digest import tree_digest
from . import kmers

SAMPLE = 10


def genome_sets(genomes: dict[str, np.ndarray], k: int, device) -> dict[str, np.ndarray]:
    """name -> ascending unique canonical k-mers (u64) of 2-bit codes."""
    out = {}
    for name, codes in genomes.items():
        keys, valid = kmers.window_keys(torch.from_numpy(codes).to(device)[None, :], k)
        out[name] = torch.unique(keys[valid], sorted=True).cpu().numpy().view(np.uint64)
    return out


def hits(reads_path, read_len, head_w, k, union: np.ndarray, device, sample: bool = False,
         block_rows: int = 1 << 20) -> tuple[np.ndarray, np.ndarray]:
    """(rows of the FASTQ, hits of each read)."""
    rows = kmers.fastq_rows(reads_path, read_len, head_w)
    lut = torch.from_numpy(kmers.code_table(normalize=False)).to(device)
    db = torch.from_numpy(union.view(np.int64)).to(device)
    out = np.zeros(rows.shape[0], np.int64)
    for lo in range(0, rows.shape[0], block_rows):
        seq = torch.from_numpy(rows[lo : lo + block_rows, head_w : head_w + read_len].copy()).to(device)
        keys, valid = kmers.window_keys(lut[seq.long()], k)
        idx = torch.searchsorted(db, keys).clamp_(max=max(db.shape[0] - 1, 0))
        member = valid & (db[idx] == keys) if db.shape[0] else torch.zeros_like(valid)
        if sample:
            bucket = ((keys * -7046029254386353131) >> 32) & 0xFFFFFFFF
            member &= (bucket % SAMPLE) == 0
            out[lo : lo + seq.shape[0]] = SAMPLE * member.sum(1).cpu().numpy()
        else:
            out[lo : lo + seq.shape[0]] = member.sum(1).cpu().numpy()
    return rows, out


def outputs(rows: np.ndarray, read_hits: np.ndarray, head_w: int, read_len: int, k: int,
            min_hits: int, pool) -> dict:
    passing = (read_hits >= min_hits) & (read_len >= k)
    ids = rows[passing, 1:head_w]  # the id and its newline
    return {"ids": tree_digest(np.ascontiguousarray(ids), pool), "passing": int(passing.sum())}


def expected(reads_path, read_len, head_w, k, union, min_hits, device, pool) -> dict:
    rows, h = hits(reads_path, read_len, head_w, k, union, device)
    return outputs(rows, h, head_w, read_len, k, min_hits, pool)


def control(reads_path, read_len, head_w, k, union, min_hits, device, pool) -> dict:
    rows, h = hits(reads_path, read_len, head_w, k, union, device, sample=True)
    return outputs(rows, h, head_w, read_len, k, min_hits, pool)
