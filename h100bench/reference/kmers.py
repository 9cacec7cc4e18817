"""The canonical k-mer arithmetic, in plain PyTorch: the yardstick of every
cell's output.

A frozen copy of the semantics of the upstream orion-kmer ``kmer.rs``, as
the port's ``codec.py`` states them: A=0, C=1, G=2, T=3, case-insensitive;
a k-mer packs MSB-first into an integer; any other byte invalidates every
window that holds it; the reverse complement is each base XOR 3 in reverse
order; the canonical value is the smaller of the two as unsigned integers.
Values stay below 2^62 for k <= 31 and below 2^64 for k = 32; k = 32 is
not used here, so signed int64 order is the unsigned order.

Nothing here imports the port or JAX.
"""

from __future__ import annotations

import numpy as np
import torch

BASES = b"ACGT"
INVALID = 4  # the code of a byte that is not a base


def code_table(normalize: bool) -> np.ndarray:
    """Byte -> 2-bit code (INVALID elsewhere); ``normalize`` also takes
    lower case and U/u as T, as count and build read their input."""
    lut = np.full(256, INVALID, np.uint8)
    for i, b in enumerate(BASES):
        lut[b] = i
        if normalize:
            lut[b + 32] = i
    if normalize:
        lut[ord("U")] = lut[ord("u")] = 3
    return lut


def window_keys(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical values of every window of each row of ``codes`` (uint8
    [rows, L], INVALID where not a base) and whether the window is valid:
    two int64 / bool tensors of [rows, L - k + 1]."""
    if not 1 <= k <= 31:
        raise ValueError(f"k = {k} outside 1..31")
    rows, length = codes.shape
    nw = length - k + 1
    if nw <= 0:
        empty = torch.empty((rows, 0), dtype=torch.int64, device=codes.device)
        return empty, empty.bool()
    bad = codes >= INVALID
    c = codes.masked_fill(bad, 0).to(torch.int64)
    fwd = torch.zeros((rows, nw), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        col = c[:, j : j + nw]
        fwd = (fwd << 2) | col
        rc |= (3 - col) << (2 * j)
    nbad = torch.zeros((rows, length + 1), dtype=torch.int32, device=codes.device)
    torch.cumsum(bad.to(torch.int32), dim=1, out=nbad[:, 1:])
    valid = (nbad[:, k:] - nbad[:, :nw]) == 0
    return torch.minimum(fwd, rc), valid


def count_runs(runs: list[tuple[torch.Tensor, torch.Tensor]]) -> tuple[torch.Tensor, torch.Tensor]:
    """(ascending unique values, int64 counts) of counted runs merged,
    counts of equal values summed."""
    if not runs:
        z = torch.empty(0, dtype=torch.int64)
        return z, z.clone()
    vals = torch.cat([r[0] for r in runs])
    counts = torch.cat([r[1] for r in runs])
    uniq, inverse = torch.unique(vals, sorted=True, return_inverse=True)
    total = torch.zeros(uniq.shape[0], dtype=torch.int64, device=vals.device)
    total.index_add_(0, inverse, counts)
    return uniq, total


def counted(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ascending unique values, counts) of a flat int64 tensor."""
    uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    return uniq, counts.to(torch.int64)


def narrowed(vals: torch.Tensor, counts: torch.Tensor, bits: int = 40):
    """The control's k-mers keyed by a ``bits``-bit multiplicative hash,
    as an approximate counter keys them: values of one bucket merge into
    its smallest, their counts summed.  (ascending values, counts)."""
    h = ((vals * -7046029254386353131) >> (64 - bits)) & ((1 << bits) - 1)
    buckets, inverse = torch.unique(h, return_inverse=True)
    rep = torch.full((buckets.shape[0],), torch.iinfo(torch.int64).max, dtype=torch.int64, device=vals.device)
    rep.scatter_reduce_(0, inverse, vals, reduce="amin")
    total = torch.zeros(buckets.shape[0], dtype=torch.int64, device=vals.device)
    total.index_add_(0, inverse, counts)
    order = torch.argsort(rep)
    return rep[order], total[order]


def render_tsv(vals: torch.Tensor, counts: torch.Tensor, k: int) -> np.ndarray:
    """``KMER\\tCOUNT\\n`` lines of ascending values, rendered on the
    values' device; the bytes as a host array."""
    n = vals.shape[0]
    dev = vals.device
    if n == 0:
        return np.empty(0, np.uint8)
    lut = torch.tensor(list(BASES), dtype=torch.uint8, device=dev)
    nd = torch.ones(n, dtype=torch.int64, device=dev)
    for p in range(1, 19):
        nd += (counts >= 10**p).to(torch.int64)
    line = k + 2 + nd
    off = torch.cumsum(line, 0) - line
    out = torch.empty(int(line.sum()), dtype=torch.uint8, device=dev)
    for j in range(k):
        out[off + j] = lut[(vals >> (2 * (k - 1 - j))) & 3]
    out[off + k] = ord("\t")
    for j in range(int(nd.max())):
        sel = nd > j
        digit = (counts[sel] // 10 ** (nd[sel] - 1 - j)) % 10
        out[off[sel] + k + 1 + j] = (ord("0") + digit).to(torch.uint8)
    out[off + line - 1] = ord("\n")
    return out.cpu().numpy()


def histogram_bytes(counts: torch.Tensor) -> bytes:
    """``MULTIPLICITY\\tDISTINCT\\n`` lines over every counted k-mer."""
    if counts.shape[0] == 0:
        return b""
    m, f = torch.unique(counts, sorted=True, return_counts=True)
    return "".join(f"{a}\t{b}\n" for a, b in zip(m.tolist(), f.tolist())).encode()


def fasta_codes(path, normalize: bool = True) -> np.ndarray:
    """The 2-bit codes of a one-record FASTA file (header, then lines)."""
    data = np.fromfile(path, np.uint8)
    first = int(np.flatnonzero(data == ord("\n"))[0])
    if data[0] != ord(">"):
        raise ValueError(f"{path}: not a FASTA record")
    seq = data[first + 1 :]
    seq = seq[seq != ord("\n")]
    return code_table(normalize)[seq]


def fastq_rows(path, read_len: int, head_w: int) -> np.ndarray:
    """The rows of a FASTQ of fixed-width records (``head_w`` bytes of
    header with its newline, the read, ``\\n+\\n``, the qualities and a
    newline), as a uint8 [records, width] array; the layout is checked."""
    width = head_w + 2 * read_len + 4
    data = np.fromfile(path, np.uint8)
    if data.shape[0] % width:
        raise ValueError(f"{path}: {data.shape[0]} bytes are not records of {width}")
    rows = data.reshape(-1, width)
    sep = rows[:, head_w + read_len : head_w + read_len + 3]
    if not ((rows[:, 0] == ord("@")).all() and (rows[:, head_w - 1] == ord("\n")).all()
            and (sep == np.frombuffer(b"\n+\n", np.uint8)).all() and (rows[:, -1] == ord("\n")).all()):
        raise ValueError(f"{path}: records are not of the fixed layout")
    return rows
