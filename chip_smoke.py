#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orion_kmer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--gbp G]

    python3 chip_smoke.py --kernels-only   # phases 1-3 only, no result line

Phases, in order; any failure raises and exits non-zero:
  1. device: the card's name and power limit, native ingest status;
  2. build: compile the CUDA kernels of orion_kmer_tpu_torch/csrc, print
     ptxas's registers and spills per kernel, fail if K1 or K4 spills;
  3. kernels: K1 (extract, every k in 1..32 at two batch lengths), K2
     (merge), K3 (compact) and K4 (block sort, n from 1 to 2^14 across
     every cluster size) against their plain torch versions on the card,
     at the main path's shapes, exactly, with device times from CUDA
     events around back-to-back calls (median_ms), beside the library
     call that computes the same function and the card's bound;
  4. exact run: `count` at k = 15, 21, 31, 32 (once with small batches
     and a lowered device-table bound, so the forest deepens and the table
     spills), `build -k 21`, the T*40 k = 32 edge, `compare`, `query -c 1`
     and `-c 5` and `classify -m 2 --output-tsv`, all through the CLI in
     subprocesses, exactly against the numpy oracle of the port's own
     codec.py;
  5. realistic run: `count -k 31 -m 2 --histogram` over a synthetic
     E. coli-like FASTQ (a 4.64 Mbp genome, 150 bp reads, 0.2 %
     substitutions, a few N runs; --gbp of sequence), in process, with the
     kernel launch counters reset just before it; checks the histogram
     mass against the valid windows, ascending output keys and canonical
     output k-mers;
  6. realistic joins, in process, counters reset before each command:
     `build -k 31` of three references (the phase-5 genome, a copy with
     1 % substitutions, an unrelated 5 Mbp genome), `query -c 10` and
     `classify -m 2 --output-tsv` over the phase-5 reads, and `compare`
     against a DB of the first two references; each checked exactly
     against the oracle (query: every read's hit count from
     ``engine.query_hits`` against the ids written, and the counts of a
     sample of 20,000 reads against the oracle); then K4's own
     entry, `sort_pairs`, on canonical keys of the reads (no command
     reaches K4).
The last line is the result JSON; the kernel JSON and the card's
`nvidia-smi` name and power limit are printed before it.  Needs no
network and no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BASES = b"ACGT"
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def bound_ms(n_bytes: float) -> float:
    """Least time for the card to move n_bytes through device memory."""
    return n_bytes / HBM_BYTES_PER_MS


def median_ms(torch, fn, calls: int = 20, reps: int = 7) -> float:
    """Device time of one fn() call: the median over reps of `calls`
    back-to-back calls between two CUDA events, divided by `calls`.  A
    sleep kernel holds the stream while the host enqueues the calls, so
    the host's launch overhead between calls is not timed (unless fn
    waits for the device itself, as boolean indexing does)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)  # ~2 ms at the card's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_ms(torch, fn, name: str, calls: int = 20):
    """Device time per call of the kernels whose name contains `name`, by
    torch.profiler; None where the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.key_averages() if name in e.key]
    return sum(us) / calls / 1000 if us else None


def max_abs_err(torch, a, b) -> float:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


# ---------------------------------------------------------------- oracle


def oracle_counts(np, codec, records, k):
    """Exact canonical counts of records: codec.extract_kmers_np + np.unique."""
    vals = [codec.extract_kmers_np(codec.seq_to_codes(r), k) for r in records]
    return np.unique(np.concatenate(vals) if vals else np.empty(0, np.uint64), return_counts=True)


def sorted_unique(np, values):
    """np.unique by a sort (numpy 2.3.5 hashes, many times slower)."""
    a = np.sort(values)
    return a[np.concatenate([[True], a[1:] != a[:-1]])] if a.shape[0] else a


def window_hits(np, codec, reads, k, db):
    """Per-read count of k-mer windows (raw bytes, multiplicity counted)
    whose canonical value is in the sorted array db."""
    sep = np.full(k - 1, 255, np.uint8)
    codes = np.concatenate([x for r in reads for x in (codec.seq_to_codes(r, normalize=False), sep)])
    lens = np.array([len(r) + k - 1 for r in reads], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    nwin = codes.shape[0] - k + 1
    vals = np.zeros(nwin, np.uint64)
    c64 = np.where(codes > 3, 0, codes).astype(np.uint64)
    for j in range(k):
        vals = (vals << np.uint64(2)) | c64[j : j + nwin]
    bad = np.concatenate([[0], np.cumsum(codes > 3)])
    ok = (bad[k:] - bad[:-k]) == 0
    hit = ok & np.isin(codec.canonical_u64(vals, k), db)
    owner = np.searchsorted(starts, np.arange(nwin), side="right") - 1
    return np.bincount(owner, weights=hit, minlength=len(reads)).astype(np.int64)


def render_tsv(np, vals, counts, k) -> bytes:
    """`KMER\\tCOUNT\\n` lines, rendered with numpy alone."""
    n = vals.shape[0]
    if n == 0:
        return b""
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    chars = np.frombuffer(BASES, np.uint8)[((vals[:, None] >> shifts) & np.uint64(3)).astype(np.int64)]
    counts = counts.astype(np.int64)
    nd = np.ones(n, np.int64)
    for p in range(1, 19):
        nd += counts >= 10**p
    line = k + 2 + nd
    off = np.concatenate([[0], np.cumsum(line)[:-1]])
    out = np.empty(int(line.sum()), np.uint8)
    out[off[:, None] + np.arange(k)] = chars
    out[off + k] = ord("\t")
    for j in range(int(nd.max())):
        sel = nd > j
        digit = (counts[sel] // 10 ** (nd[sel] - 1 - j)) % 10
        out[off[sel] + k + 1 + j] = ord("0") + digit
    out[off + line - 1] = ord("\n")
    return out.tobytes()


def parse_tsv(np, codec, data: bytes, k: int):
    """(u64 k-mers, int64 counts) of a count TSV, vectorized."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    ends = np.flatnonzero(raw == ord("\n"))
    starts = np.concatenate([[0], ends[:-1] + 1])
    check(bool((raw[starts + k] == ord("\t")).all()), "TSV k-mer column width")
    codes = codec.seq_to_codes(raw[starts[:, None] + np.arange(k)].reshape(-1)).reshape(-1, k)
    check(bool((codes < 4).all()), "TSV k-mers are ACGT")
    vals = np.zeros(starts.shape[0], np.uint64)
    for j in range(k):
        vals = (vals << np.uint64(2)) | codes[:, j].astype(np.uint64)
    # counts: the digits between the tab and the newline
    width = ends - (starts + k + 1)
    counts = np.zeros(starts.shape[0], np.int64)
    for j in range(int(width.max())):
        live = width > j
        digit = raw[(starts + k + 1 + j)[live]].astype(np.int64) - ord("0")
        counts[live] = counts[live] * 10 + digit
    return vals, counts


# ------------------------------------------------------------- fixtures


def write_multirecord_fasta(np, path: Path, rng, total: int):
    """~total bases of multi-record, multi-line FASTA with N runs and a
    lowercase stretch per record.  Returns the records' sequences."""
    lut = np.frombuffer(BASES, np.uint8)
    records = []
    with open(path, "wb") as f:
        done = 0
        rid = 0
        while done < total:
            n = int(rng.integers(5_000, 400_000))
            s = lut[rng.integers(0, 4, n)]
            for _ in range(max(1, n // 50_000)):
                p = int(rng.integers(0, n - 30))
                s[p : p + int(rng.integers(1, 25))] = ord("N")
            p = int(rng.integers(0, n // 2))
            s[p : p + 500] += 32  # lowercase
            seq = s.tobytes()
            f.write(b">rec%d desc\n" % rid)
            f.write(b"\n".join(seq[i : i + 70] for i in range(0, n, 70)) + b"\n")
            records.append(seq)
            done += n
            rid += 1
    return records


def write_reads_fastq(np, path: Path, rng, gbp: float, read_len: int = 150, n_sample: int = 20_000):
    """Synthetic E. coli-like FASTQ: reads from both strands of one
    4.64 Mbp random genome, 0.2 % substitutions, N runs in 1 read in 5000.
    Returns (n_reads, valid 31-mer windows over all reads, the genome's
    codes, {read index: read bytes} for a random sample of reads)."""
    k = 31
    genome = rng.integers(0, 4, 4_641_652).astype(np.uint8)
    n_reads = int(gbp * 1e9) // read_len
    lut = np.frombuffer(BASES + b"N", np.uint8)
    picked = np.random.default_rng(n_reads).choice(n_reads, min(n_sample, n_reads), replace=False)
    sample = {}
    head_w = 12  # "@r" + 9 digits + "\n"
    row_w = head_w + read_len + 3 + read_len + 1
    valid = 0
    with open(path, "wb") as f:
        for base in range(0, n_reads, 200_000):
            m = min(200_000, n_reads - base)
            starts = rng.integers(0, genome.shape[0] - read_len, m)
            reads = genome[starts[:, None] + np.arange(read_len)]
            rev = rng.random(m) < 0.5
            reads[rev] = 3 - reads[rev][:, ::-1]
            err = rng.random((m, read_len)) < 0.002
            reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()))) % 4
            with_n = np.flatnonzero(rng.random(m) < 0.0002)
            for r in with_n:
                p = int(rng.integers(0, read_len - 5))
                reads[r, p : p + int(rng.integers(1, 6))] = 4
            # valid windows: read_len - k + 1 per read, fewer where N
            valid += (m - with_n.shape[0]) * (read_len - k + 1)
            if with_n.shape[0]:
                bad = np.concatenate(
                    [np.zeros((with_n.shape[0], 1), np.int64), np.cumsum(reads[with_n] == 4, axis=1)], axis=1
                )
                valid += int(((bad[:, k:] - bad[:, :-k]) == 0).sum())
            rows = np.empty((m, row_w), np.uint8)
            rows[:, 0:2] = np.frombuffer(b"@r", np.uint8)
            ids = base + np.arange(m)
            for d in range(9):
                rows[:, 2 + d] = ord("0") + (ids // 10 ** (8 - d)) % 10
            rows[:, 11] = ord("\n")
            rows[:, head_w : head_w + read_len] = lut[reads]
            rows[:, head_w + read_len : head_w + read_len + 3] = np.frombuffer(b"\n+\n", np.uint8)
            rows[:, head_w + read_len + 3 : row_w - 1] = ord("I")
            rows[:, row_w - 1] = ord("\n")
            f.write(rows.tobytes())
            for r in picked[(picked >= base) & (picked < base + m)]:
                sample[int(r)] = rows[r - base, head_w : head_w + read_len].tobytes()
    return n_reads, valid, genome, sample


def write_fasta(path: Path, name: bytes, seq: bytes) -> None:
    with open(path, "wb") as f:
        f.write(b">" + name + b"\n" + b"\n".join(seq[i : i + 70] for i in range(0, len(seq), 70)) + b"\n")


def write_query_reads(np, path: Path, rng, records, n: int = 20_000):
    """A FASTQ of reads cut from the records (with their N runs and
    lowercase stretches), random reads, and reads shorter than 21 bp.
    Returns the reads' sequences."""
    lut = np.frombuffer(BASES, np.uint8)
    reads = []
    for i in range(n):
        ln = int(rng.integers(5, 150)) if i % 10 == 0 else int(rng.integers(60, 150))
        if i % 3:
            rec = records[int(rng.integers(0, len(records)))]
            p0 = int(rng.integers(0, len(rec) - ln))
            reads.append(rec[p0 : p0 + ln])
        else:
            reads.append(lut[rng.integers(0, 4, ln)].tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(b"@q%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)) for i, r in enumerate(reads)))
    return reads


# ---------------------------------------------------------------- phases


# kernels held to zero spill bytes (the redesigned K1 and K4)
NO_SPILL = ("extract_kernel", "cluster_sort_kernel")


def check_ptxas(report) -> None:
    """Print ptxas's registers and spills per kernel (template instances of
    one kernel on one line) and fail if a NO_SPILL kernel spills."""
    groups = {}
    for k in report:
        base = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "", k["name"]).split("<")[0].split("(")[0]
        groups.setdefault(base, []).append(k)
    for name, ks in groups.items():
        regs = sorted({k["registers"] for k in ks})
        spill = sum(k["spill_stores"] + k["spill_loads"] for k in ks)
        log(f"ptxas {name}: {len(ks)} instance(s), registers {regs[0]}-{regs[-1]}, spill bytes {spill}")
        if any(n in name for n in NO_SPILL):
            check(spill == 0, f"{name} spills no registers")
    for n in NO_SPILL:
        check(any(n in name for name in groups), f"ptxas reported {n}")


def phase_kernels(np, torch, codec, dev, rng):
    """Each kernel against its plain version on the card; returns, per
    kernel, its record for the JSON line: kernel, plain and library times,
    the bound from the bytes it must move, and the largest error."""
    from orion_kmer_tpu_torch.host import pack_for_transfer
    from orion_kmer_tpu_torch.ops import compact, extract, merge, sort

    rec = {}

    # K1: a 2^24-position batch with N runs, and a batch whose length is no
    # multiple of the kernel's 4224-position tile, at every k; no library
    # call computes it
    n = 1 << 24
    codes = np.frombuffer(BASES, np.uint8)[rng.integers(0, 4, n)].copy()
    for p in rng.integers(0, n - 30, 2000):
        codes[p : p + int(rng.integers(1, 25))] = ord("N")
    err = 0.0
    for size in ((1 << 20) + 32 * 7, n):
        lanes, inv = pack_for_transfer(codec.seq_to_codes(codes[: size - 5]), size)
        L = torch.from_numpy(lanes.view(np.int32)).to(dev)
        I = torch.from_numpy(inv.view(np.int32)).to(dev)
        for k in range(1, 33):
            gk, gn = extract.extract_keys(L, I, k, size - 7)
            pk, pn = extract.extract_keys_plain(L, I, k, size - 7)
            err = max(err, max_abs_err(torch, gk, pk), abs(int(gn) - int(pn)))
    log(f"K1 extract k = 1..32 at {(1 << 20) + 32 * 7} and 2^24 positions: largest error {err}")
    for k in (15, 21, 31, 32):
        t_k = median_ms(torch, lambda: extract.extract_keys(L, I, k, n - 7))
        t_p = median_ms(torch, lambda: extract.extract_keys_plain(L, I, k, n - 7))
        t_d = kernel_ms(torch, lambda: extract.extract_keys(L, I, k, n - 7), "extract_kernel")
        log(f"K1 extract k={k} 2^24 positions: extract_keys {t_k:.4f} ms (the kernel alone {t_d} ms "
            f"by torch.profiler), plain {t_p:.3f} ms")
        if k == 31:
            rec["K1"] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                             bound_ms=bound_ms(L.numel() * 4 + I.numel() * 4 + n * 8))
    check(err == 0, "K1 agrees with its plain version")
    rec["K1"]["max_abs_err"] = err
    torch.cuda.synchronize()

    # K2: two sorted 2^24-key forest runs with many duplicates (keys only),
    # then a table-sized key + count merge of unequal lengths
    def sorted_keys(m, spread):
        return torch.sort(torch.randint(-spread, spread, (m,), device=dev)).values

    a, b = sorted_keys(1 << 24, 1 << 22), sorted_keys(1 << 24, 1 << 22)
    gk, gp = merge.merge(a, b)
    pk, _ = merge.merge_plain(a, b)
    err = max_abs_err(torch, gk, pk)
    check(gp is None, "keys-only merge has no payload")
    t_k = median_ms(torch, lambda: merge.merge(a, b))
    t_p = median_ms(torch, lambda: merge.merge_plain(a, b))
    t_l = median_ms(torch, lambda: torch.sort(torch.cat([a, b]), stable=True))
    t_b = bound_ms((a.numel() + b.numel()) * 16)
    log(f"K2 merge 2^24 + 2^24 keys: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
        f"library torch.sort(cat, stable) {t_l:.3f} ms, bound {t_b:.4f} ms")
    rec["K2"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=t_b)
    ta = torch.unique(sorted_keys(40_000_000, 1 << 40))
    tb = torch.unique(sorted_keys(9_000_000, 1 << 40))
    ca = torch.randint(1, 1000, ta.shape, device=dev)
    cb = torch.randint(1, 1000, tb.shape, device=dev)
    gk, gp = merge.merge(ta, tb, ca, cb)
    pk, pp = merge.merge_plain(ta, tb, ca, cb)
    err = max(err, max_abs_err(torch, gk, pk), max_abs_err(torch, gp, pp))
    t_k2 = median_ms(torch, lambda: merge.merge(ta, tb, ca, cb))
    t_p2 = median_ms(torch, lambda: merge.merge_plain(ta, tb, ca, cb))
    t_l2 = median_ms(torch, lambda: torch.sort(torch.cat([ta, tb]), stable=True))
    log(f"K2 merge {ta.shape[0]} + {tb.shape[0]} keys with counts: kernel {t_k2:.3f} ms, plain {t_p2:.3f} ms, "
        f"library (keys only) {t_l2:.3f} ms, bound {bound_ms((ta.numel() + tb.numel()) * 32):.4f} ms")
    check(err == 0, "K2 agrees with its plain version")
    rec["K2"]["max_abs_err"] = err
    del a, b, ta, tb, ca, cb, gk, gp, pk, pp
    torch.cuda.synchronize()

    # K3: 2^25 elements, two planes, three densities
    n = 1 << 25
    x0 = torch.randint(-(1 << 62), 1 << 62, (n,), device=dev)
    x1 = torch.arange(n, device=dev)
    err = 0.0
    for density in (0.03, 0.5, 0.97):
        keep = torch.rand(n, device=dev) < density
        (g0, g1), gn = compact.compact([x0, x1], keep)
        (p0, p1), pn = compact.compact_plain([x0, x1], keep)
        m = int(gn)
        check(m == int(pn), "K3 kept count")
        err = max(err, max_abs_err(torch, g0[:m], p0), max_abs_err(torch, g1[:m], p1))
        t_k = median_ms(torch, lambda: compact.compact([x0, x1], keep))
        t_p = median_ms(torch, lambda: compact.compact_plain([x0, x1], keep))
        t_l = median_ms(torch, lambda: (x0[keep], x1[keep]))
        t_b = bound_ms(n * (1 + 16) + m * 16)
        log(f"K3 compact 2^25 x 2 planes density {density}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
            f"library x[keep] per plane {t_l:.3f} ms, bound {t_b:.4f} ms")
        if density == 0.5:
            rec["K3"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=t_b)
    check(err == 0, "K3 agrees with its plain version")
    rec["K3"]["max_abs_err"] = err
    del x0, x1, keep
    torch.cuda.synchronize()

    # K4: a cluster of 1 to 8 CTAs sorts each n below, with duplicates and
    # the all-ones key that ties with its padding; timed at 2^14 and 12289
    err = 0.0
    for m in (1, 2, 3, 2047, 2048, 2049, 4097, 12289, 1 << 14):
        keys = torch.randint(-(1 << 62), 1 << 62, (m,), device=dev)
        keys[: m // 4] = keys[m // 4 : 2 * (m // 4)].clone()
        keys[0] = (1 << 63) - 1
        err = max(err, max_abs_err(torch, sort.sort_pairs(keys), sort.sort_pairs_plain(keys)))
        if m < 12289:
            continue
        t_k = median_ms(torch, lambda: sort.sort_pairs(keys))
        t_p = median_ms(torch, lambda: sort.sort_pairs_plain(keys))
        t_l = median_ms(torch, lambda: torch.sort(keys))
        t_d = kernel_ms(torch, lambda: sort.sort_pairs(keys), "cluster_sort_kernel")
        t_b = bound_ms(m * 16)
        log(f"K4 sort {m} keys: sort_pairs {t_k:.4f} ms (the kernel alone {t_d} ms by torch.profiler), "
            f"plain {t_p:.4f} ms, library torch.sort {t_l:.4f} ms, bound {t_b:.6f} ms")
        if m == 1 << 14:
            rec["K4"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=t_b)
    check(err == 0, "K4 agrees with its plain version")
    rec["K4"]["max_abs_err"] = err
    torch.cuda.synchronize()
    log(f"launch counters after phase 3: K1 {extract.launches} K2 {merge.launches} "
        f"K3 {compact.launches} K4 {sort.launches}")
    return rec


def run_cli(args, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    proc = subprocess.run(
        [sys.executable, "-m", "orion_kmer_tpu_torch", *map(str, args)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"CLI {args} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")


CLASSIFY_TSV_HEADER = (
    "InputFile\tDatabase\tReference\tTotalKmersInReference\tInputKmersHittingReference\t"
    "SumDepthMatchedKmers\tAvgDepthMatchedKmers\tProportionInputKmersHittingReference\t"
    "ReferenceBreadthOfCoverage\n"
)


def check_classify(np, json_path: Path, tsv_path: Path, input_path, db_path, refs, vals, counts):
    """classify's JSON and TSV against the oracle: per reference (sorted
    names), the filtered input k-mers (vals, counts) it holds and their
    depth sum; overall, their union."""
    lines = [CLASSIFY_TSV_HEADER]
    n_in = vals.shape[0]
    in_any = np.zeros(n_in, bool)
    for name in sorted(refs):
        total = refs[name].shape[0]
        hit = np.isin(vals, refs[name])
        in_any |= hit
        matched, depth = int(hit.sum()), int(counts[hit].sum())
        avg = depth / matched if matched else 0.0
        prop = matched / n_in if n_in else 0.0
        breadth = matched / total if total else 0.0
        lines.append(f"{input_path}\t{db_path}\t{name}\t{total}\t{matched}\t{depth}\t{avg:.4f}\t{prop:.4f}\t{breadth:.4f}\n")
    check(tsv_path.read_text() == "".join(lines), f"classify TSV {tsv_path.name} == oracle")
    doc = json.loads(json_path.read_text())
    res = doc["databases_analyzed"][0]
    check(doc["total_unique_kmers_in_input"] == n_in, "classify input k-mers after the filter")
    check(res["overall_input_kmers_matched_in_db"] == int(in_any.sum()), "classify overall matched")
    check(res["overall_sum_depth_of_matched_kmers_in_input"] == int(counts[in_any].sum()), "classify overall depth")
    return len(lines) - 1


def phase_exact(np, codec, work: Path, rng):
    from orion_kmer_tpu_torch.db import KmerDb

    fa = work / "big.fasta"
    records = write_multirecord_fasta(np, fa, rng, 9_000_000)
    log(f"exact run: {len(records)} records, {sum(map(len, records))} bases")
    tedge = work / "tedge.fasta"
    tedge.write_bytes(b">t\n" + b"T" * 40 + b"\n")
    small = work / "small.fasta"
    small_recs = write_multirecord_fasta(np, small, rng, 300_000)

    runs = [(k, {}) for k in (15, 21, 31, 32)]
    runs.append((31, {"ORION_KMER_BATCH": "1048576", "ORION_KMER_DEVICE_TABLE_MAX": str(1 << 21)}))
    for k, env in runs:
        t0 = time.monotonic()
        out = work / f"count_k{k}.tsv"
        run_cli(["count", "-k", k, "-i", fa, "-o", out], env)
        wall = time.monotonic() - t0
        vals, counts = oracle_counts(np, codec, records, k)
        check(out.read_bytes() == render_tsv(np, vals, counts, k), f"count k={k} {env} TSV == oracle")
        log(f"count k={k} {env or ''}: {vals.shape[0]} k-mers, byte-exact, {wall:.1f} s with process start")

    out = work / "t.tsv"
    run_cli(["count", "-k", 32, "-i", tedge, "-o", out])
    check(out.read_bytes() == b"A" * 32 + b"\t9\n", "T*40 at k=32")
    log("count k=32 T*40 edge: exact")

    db = work / "db.db"
    run_cli(["build", "-k", 21, "-g", fa, small, "-o", db])
    ref = KmerDb(k=21)
    for name, recs in (("big.fasta", records), ("small.fasta", small_recs)):
        ref.add_reference(name, oracle_counts(np, codec, recs, 21)[0])
    check(db.read_bytes() == ref.to_bincode(), "build -k 21 .db == oracle round trip")
    check(KmerDb.load(db).total_unique_kmers() == ref.total_unique_kmers(), "db reload")
    log(f"build -k 21: {ref.total_unique_kmers()} unique k-mers, byte-exact")

    # the joins on the same DB
    union = ref.get_all_kmers_unified()
    small_db = work / "small.db"
    run_cli(["build", "-k", 21, "-g", small, "-o", small_db])
    for other, other_set in ((db, union), (small_db, ref.references["small.fasta"])):
        out = work / "cmp.json"
        run_cli(["compare", "--db1", db, "--db2", other, "-o", out])
        got = json.loads(out.read_text())
        inter = int(np.intersect1d(union, other_set).shape[0])
        u = union.shape[0] + other_set.shape[0] - inter
        check(got["intersection_size"] == inter and got["union_size"] == u and got["jaccard_index"] == inter / u,
              f"compare with {other.name} == np.intersect1d")
        log(f"compare db.db {other.name}: intersection {inter}, union {u}, exact")

    fq = work / "q.fastq"
    reads = write_query_reads(np, fq, rng, records)
    hits = window_hits(np, codec, reads, 21, union)
    for c in (1, 5):
        out = work / f"q{c}.txt"
        run_cli(["query", "-d", db, "-r", fq, "-o", out, "-c", c])
        exp = b"".join(b"q%d\n" % i for i, (r, h) in enumerate(zip(reads, hits.tolist())) if h >= c and len(r) >= 21)
        check(out.read_bytes() == exp, f"query -c {c} == oracle")
        n_hit = exp.count(b"\n")
        log(f"query -c {c}: {n_hit} of {len(reads)} reads, exact")

    out, tsv = work / "cl.json", work / "cl.tsv"
    run_cli(["classify", "-i", fq, "-d", db, "-o", out, "--min-kmer-frequency", 2, "--output-tsv", tsv])
    vals, counts = oracle_counts(np, codec, reads, 21)
    keep = counts >= 2
    n_refs = check_classify(np, out, tsv, fq, db, ref.references, vals[keep], counts[keep])
    log(f"classify -m 2: {int(keep.sum())} input k-mers, {n_refs} references, exact")


def phase_realistic(np, torch, codec, work: Path, rng, gbp: float, dev):
    from orion_kmer_tpu_torch import cli
    from orion_kmer_tpu_torch.ops import compact, extract, merge

    fq = work / "reads.fastq"
    t0 = time.monotonic()
    n_reads, n_windows, genome, read_sample = write_reads_fastq(np, fq, rng, gbp)
    log(f"realistic run: {n_reads} reads x 150 bp ({fq.stat().st_size} bytes), "
        f"{n_windows} valid 31-mer windows, generated in {time.monotonic() - t0:.1f} s")
    out, hist = work / "reads.tsv", work / "reads.hist"

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    extract.launches = merge.launches = compact.launches = 0
    t0 = time.monotonic()
    rc = cli.main(["count", "-k", "31", "-m", "2", "--histogram", str(hist), "-i", str(fq), "-o", str(out)])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"K1": extract.launches, "K2": merge.launches, "K3": compact.launches}
    check(rc == 0, "count exit code")
    peak = torch.cuda.max_memory_allocated(dev)

    h = np.loadtxt(hist, dtype=np.int64, ndmin=2)
    check(int((h[:, 0] * h[:, 1]).sum()) == n_windows, "histogram mass == valid windows")
    vals = parse_tsv(np, codec, out.read_bytes(), 31)[0]
    check(vals.shape[0] == int(h[h[:, 0] >= 2, 1].sum()), "TSV lines == k-mers with count >= 2")
    check(bool((vals[1:] > vals[:-1]).all()), "output keys strictly ascending")
    sample = vals[rng.choice(vals.shape[0], min(100_000, vals.shape[0]), replace=False)]
    check(bool((codec.canonical_u64(sample, 31) == sample).all()), "sampled k-mers are canonical")
    log(f"count -k 31 -m 2: wall {wall:.3f} s, {n_windows / wall / 1e6:.3f} M k-mers/s, "
        f"{int(h[:, 1].sum())} distinct, {vals.shape[0]} with count >= 2, "
        f"peak device memory {peak / 2**30:.3f} GiB; card: {gpu_name_and_limit()}")
    log(f"launches in the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched in the main path")
    return launches, fq, out, n_reads, n_windows, genome, read_sample


def phase_joins(np, torch, codec, work: Path, rng, dev, fq, count_tsv, n_reads, n_windows, genome, sample):
    """The realistic joins, each command in process with the launch
    counters zeroed just before it; returns the launches of each run."""
    from orion_kmer_tpu_torch import cli, engine
    from orion_kmer_tpu_torch.db import KmerDb
    from orion_kmer_tpu_torch.keys import keys_from_u64, u64_from_keys
    from orion_kmer_tpu_torch.ops import compact, extract, merge, sort

    k = 31
    kernels = {"K1": extract, "K2": merge, "K3": compact, "K4": sort}

    def drive(argv):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for mod in kernels.values():
            mod.launches = 0
        t0 = time.monotonic()
        rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        check(rc == 0, f"{argv[0]} exit code")
        return wall, {name: mod.launches for name, mod in kernels.items()}, torch.cuda.max_memory_allocated(dev)

    def report(what, wall, launches, peak, extra=""):
        log(f"{what}: wall {wall:.3f} s{extra}, peak device memory {peak / 2**30:.3f} GiB, launches {launches}")

    lut = np.frombuffer(BASES, np.uint8)
    g_b = genome.copy()
    subs = rng.random(g_b.shape[0]) < 0.01
    g_b[subs] = (g_b[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    g_c = rng.integers(0, 4, 5_000_000).astype(np.uint8)
    refs, paths = {}, []
    for name, g in (("genomeA.fa", genome), ("genomeB.fa", g_b), ("genomeC.fa", g_c)):
        write_fasta(work / name, name.encode(), lut[g].tobytes())
        paths.append(work / name)
        refs[name] = sorted_unique(np, codec.extract_kmers_np(g, k))
    union = sorted_unique(np, np.concatenate(list(refs.values())))
    runs = {}

    db = work / "refs.db"
    wall, launches, peak = drive(["build", "-k", k, "-g", *paths, "-o", db])
    got = KmerDb.load(db).references
    check(sorted(got) == sorted(refs) and all(np.array_equal(got[n], refs[n]) for n in refs), "build -k 31 == oracle")
    report(f"build -k 31 of 3 references ({union.shape[0]} unique 31-mers)", wall, launches, peak)
    runs["build"] = launches

    ids = work / "ids.txt"
    wall, launches, peak = drive(["query", "-d", db, "-r", fq, "-o", ids, "-c", 10])
    # the per-read hit counts under the run (same batches): every read's
    # against the ids written, the sampled reads' exactly against the oracle
    all_ids, _, all_hits = engine.query_hits(union, fq, k, dev)
    check(ids.read_bytes() == b"".join(i + b"\n" for i, h in zip(all_ids, all_hits.tolist()) if h >= 10),
          "query -c 10 ids == reads with >= 10 hits")
    picked = sorted(sample)
    hits = window_hits(np, codec, [sample[i] for i in picked], k, union)
    check(all_hits.shape[0] == n_reads and np.array_equal(all_hits[picked], hits),
          f"query hits == oracle on {len(picked)} sampled reads")
    q = np.percentile(hits, [0, 1, 50, 100]).tolist()
    report(f"query -c 10 ({int((all_hits >= 10).sum())} of {n_reads} reads reported; hit counts of "
           f"{len(picked)} sampled reads exact, min/1st pct/median/max {q})", wall, launches, peak,
           f", {n_windows / wall / 1e6:.3f} M windows/s")
    runs["query"] = launches

    out, tsv = work / "cl.json", work / "cl.tsv"
    wall, launches, peak = drive(["classify", "-i", fq, "-d", db, "-o", out, "--min-kmer-frequency", 2, "--output-tsv", tsv])
    vals, counts = parse_tsv(np, codec, count_tsv.read_bytes(), k)
    check_classify(np, out, tsv, fq, db, refs, vals, counts)
    report(f"classify -m 2 ({vals.shape[0]} input k-mers, exact)", wall, launches, peak)
    runs["classify"] = launches

    db2, cmp_out = work / "ab.db", work / "cmp.json"
    check(cli.main(["build", "-k", str(k), "-g", str(paths[0]), str(paths[1]), "-o", str(db2)]) == 0, "build A B")
    wall, launches, peak = drive(["compare", "--db1", db, "--db2", db2, "-o", cmp_out])
    u2 = sorted_unique(np, np.concatenate([refs["genomeA.fa"], refs["genomeB.fa"]]))
    inter = int(np.intersect1d(union, u2).shape[0])
    got = json.loads(cmp_out.read_text())
    check(got["intersection_size"] == inter and got["union_size"] == union.shape[0] + u2.shape[0] - inter,
          "compare == np.intersect1d")
    report(f"compare ({inter} shared 31-mers, exact)", wall, launches, peak)
    runs["compare"] = launches

    for what in ("query", "classify", "compare"):
        check(runs[what]["K2"] > 0, f"K2 launched in {what}")
    check(runs["query"]["K1"] > 0, "K1 launched in query")

    # K4's own path: no command reaches it, so drive its entry, sort_pairs,
    # on canonical 31-mers of the reads
    for mod in kernels.values():
        mod.launches = 0
    vals = np.concatenate([codec.extract_kmers_np(codec.seq_to_codes(sample[i]), k) for i in picked[:200]])
    for m in (1 << 14, 12289):
        got = u64_from_keys(sort.sort_pairs(keys_from_u64(vals[:m]).to(dev)))
        check(np.array_equal(got, np.sort(vals[:m])), f"sort_pairs of {m} keys == np.sort")
    runs["sort_pairs"] = {name: mod.launches for name, mod in kernels.items()}
    log(f"sort_pairs entry: launches {runs['sort_pairs']}")
    check(runs["sort_pairs"]["K4"] == 2, "K4 launched by its entry")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gbp", type=float, default=0.5, help="Gbp of reads in the realistic run")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and kernels), printing no result line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not (ROOT / "orion_kmer_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from orion_kmer_tpu_torch import _kernels, codec
    from orion_kmer_tpu_torch.ingest import native

    dev = torch.device("cuda")
    card = gpu_name_and_limit()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, numpy {np.__version__}; "
        f"native ingest available: {native.available()}")

    t0 = time.monotonic()
    _kernels.lib()
    log(f"phase 2 build: kernels built and loaded in {time.monotonic() - t0:.1f} s")
    check_ptxas(_kernels.ptxas_report())

    rng = np.random.default_rng(args.seed)
    rec = phase_kernels(np, torch, codec, dev, rng)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the CLI subprocesses of phase 4 share the card
    log("phase 3 kernels: exact")
    if args.kernels_only:
        log(f"{card}; stopped after phase 3 (--kernels-only): no result line")
        return 0

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        phase_exact(np, codec, work, rng)
        log("phase 4 exact run: passed")
        launches, fq, count_tsv, n_reads, n_windows, genome, sample = phase_realistic(
            np, torch, codec, work, rng, args.gbp, dev
        )
        log("phase 5 realistic run: passed")
        runs = phase_joins(np, torch, codec, work, rng, dev, fq, count_tsv, n_reads, n_windows, genome, sample)
        log("phase 6 realistic joins: passed")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # launches: K1-K3 summed over the command runs of phases 5 and 6; K4,
    # which no command reaches, from its entry's run
    runs["count"] = launches
    total = {key: sum(r[key] for name, r in runs.items() if name != "sort_pairs") for key in ("K1", "K2", "K3")}
    total["K4"] = runs["sort_pairs"]["K4"]
    pkg = "orion_kmer_tpu_torch/csrc"
    kernels = [
        ("K1 extract", f"{pkg}/extract.cu", "orion_kmer_tpu/ops/kmers_pallas.py:29"),
        ("K2 merge", f"{pkg}/merge.cu", "orion_kmer_tpu/ops/sort_pallas.py:222"),
        ("K3 compact", f"{pkg}/compact.cu", "orion_kmer_tpu/ops/sort_pallas.py:463"),
        ("K4 sort", f"{pkg}/sort.cu", "orion_kmer_tpu/ops/sort_pallas.py:153"),
    ]
    out = []
    for name, source, replaces in kernels:
        key = name.split()[0]
        r = rec[key]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": total[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["library_ms"],
        })
    log(card)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
