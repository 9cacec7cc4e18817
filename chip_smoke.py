#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orion_kmer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--gbp G]

    python3 chip_smoke.py --kernels-only   # phases 1-3 only, no result line
    python3 chip_smoke.py --sharded-only   # phases 1-3, 5, 10 and 11, no result line

Phases, in order; any failure raises and exits non-zero:
  1. device: the card's name and power limit, native ingest status;
  2. build: compile the CUDA kernels of orion_kmer_tpu_torch/csrc, print
     ptxas's registers and spills per kernel, fail if any kernel spills;
  3. kernels: K1 (extract, every k in 1..32 at two batch lengths), K2
     (merge in its three modes -- keys only, payload, the fold's sums and
     keep flags -- at lengths around its tiles, with ties across tile
     edges, one run below the other and long sentinel tails, each case 20
     times and byte-equal to its first run; then at every main-path
     shape: every level of the single table's and a shard's forest, up
     to the flush's last merge of 2^27 + 2^27, the fold, a shard's fold,
     the join; and the whole combine_sorted_unique at the fold's size), K3
     (compact: every mode
     -- one and two planes, positions, the S-way route -- at lengths
     around its tile and up to 2^25, aligned and not, densities 0 to 1,
     S = 1..5 and 8, keys with the sentinel and A^32, and at the main
     path's largest sizes -- positions over the flush's 2^28-key run, two
     planes at the fold's 49 M elements -- each case 20 times and
     byte-equal to its first run; the flush's whole rle_sorted against
     torch.unique_consecutive; then timed at every shape the main path
     gives it) and K4 (block sort, n from 1 to 2^14 across every
     cluster size) against their plain torch versions on the card,
     exactly, with device times from CUDA events around back-to-back calls
     (median_ms), beside the library call that computes the same function
     and the card's bound; the sketch's hash and keep chain (torch ops)
     per 2^24 batch; the sharded count's route step (one K3 launch over a
     shard's 2^22-position block); and, where more than one card is
     visible, every kernel on the last card while the first stays
     current;
  4. exact run: `count` at k = 15, 21, 31, 32 (once with small batches
     and a lowered device-table bound, so the forest deepens and the table
     spills), `build -k 21`, the T*40 k = 32 edge, `compare`, `query -c 1`
     and `-c 5` and `classify -m 2 --output-tsv`, all through the CLI in
     subprocesses (four at a time), exactly against the numpy oracle of
     the port's own codec.py; then `count`, `query -c 1` and `sketch` at
     ORION_KMER_BATCH = k - 1 (every path takes batches of k), of a
     24-base record at k = 9 and of 10 query reads at k = 21, against the
     same oracle;
  5. realistic run: `count -k 31 -m 2 --histogram` over a synthetic
     E. coli-like FASTQ (a 4.64 Mbp genome, 150 bp reads, 0.2 %
     substitutions, a few N runs; --gbp of sequence), in process, with the
     kernel launch counters reset just before it; its TSV and histogram
     byte-equal to the numpy oracle (oracle_reads_counts), its table
     fetched by staging.fetch_table from the card and its tail written by
     the one native pass (native.render_counts), np.unique's histogram not
     taken; the same command at -m 1
     and at -m above the largest count, at -t 1 and at the default, each
     against the oracle; one `tail: {...}` line (the fetch of the table
     from the card, and at -t 1 and the default the fused pass alone, the
     histogram's lines and the whole write, in seconds).  Beside it the
     host stage: the host's core counts, the parse's positions/s at 1, 2,
     4, 8 and 16 parser threads and at the default -t, the warm
     engine.count_file wall at -t 1 and at the default (equal results),
     the device busy share of the default's run (torch.profiler), and the
     CLI `count` in a fresh process at -t 1 and -t 0 with its wall and
     peak RSS (sampled every 10 ms), both outputs byte-equal to the
     oracle; then the CLI's cold start stage by stage: rungs 0, 2, 8, 9
     and 10 (`count` only) of tools/torch_startup.py's ladder once each in
     a fresh process (one `startup: {...}` line: every rung's wall, each
     stage's cost, the exits);
  6. realistic joins, in process, counters reset before each command:
     `build -k 31` of three references (the phase-5 genome, a copy with
     1 % substitutions, an unrelated 5 Mbp genome), `query -c 10` and
     `classify -m 2 --output-tsv` over the phase-5 reads, and `compare`
     against a DB of the first two references; each checked exactly
     against the oracle (query: every read's hit count from
     ``engine.query_hits`` against the ids written, and the counts of a
     sample of 20,000 reads against the oracle; the same query warm at
     -t 1 and at the default, byte-equal, with its device busy share
     (torch.profiler) and its host stages: parse, cut, pack and copy,
     the consumer's waits, the device; classify's busy share too); then
     K4's own entry, `sort_pairs`, on canonical keys of the reads (no
     command reaches K4);
  7. sketch (BASELINE config #3): `sketch -k 31 --scaled 1000` of 50
     synthetic 5 Mbp genomes in 5 clades (0.1-5 % substitutions from each
     clade's ancestor) and of the phase-5 reads, and `sketch-compare` of
     the 50 (1,225 pairs): every genome's sketch and every pair exactly
     against the numpy oracle, the reads' sketch against the phase-5
     count table (see phase_sketch);
  8. profile (BASELINE config #4, one card): `profile -k 31 -d DB
     --scaled 1000` of the phase-5 reads, a smaller sample and a missing
     file, against the oracle (see phase_profile);
  9. serve: `serve --warm-k 31` in a subprocess; a `count` and a `sketch`
     forwarded twice each, byte-equal to direct runs, with the walls of
     the first and second request; shutdown removes the socket;
 10. sharded count: the phase-5 command with ORION_KMER_SHARDS=4 (TSV and
     histogram byte-equal to phase 5's), ORION_KMER_SHARDS=3 on the 9 Mbp
     FASTA at k = 21 against the oracle, and `sharded_count` and
     `ShardedCountTable` on the T*40 k = 32 edge; both counts route each
     block in one K3 launch (as many route launches as K1 launches); the
     shards take one card each where the host has them and share the
     card otherwise;
 11. processes: `run_two_process_smoke` on the card(s), two ranks of one
     shard and two ranks of two shards (k = 9, 21, 32 and the T*40 edge;
     gloo with every shard on the one card, or nccl with the ranks'
     shares of four cards), a process group of one rank over nccl that
     takes every card, and two ranks of two shards counting the 9 Mbp
     FASTA at k = 21 (wall, stats and launches printed), each against the
     oracle.
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


T_START = time.monotonic()


def passed(phase: str) -> None:
    log(f"{phase}: passed ({time.monotonic() - T_START:.0f} s since the start)")


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


SLEEP_CYCLES = 4_000_000  # ~2 ms at the card's clock
SLEEP_CYCLES_MAX = 1 << 27  # ~68 ms


def median_ms(torch, fn, calls: int = 20, reps: int = 7) -> float:
    """Device time of one fn() call: the median over reps of `calls`
    back-to-back calls between two CUDA events, divided by `calls`.  A
    sleep kernel holds the stream while the host enqueues the calls, so
    the host's launch overhead between calls is not timed.  Where the
    sleep had already ended when the last call was enqueued (the start
    event reached), the device may have waited on the host: that rep runs
    again behind a sleep twice as long, up to SLEEP_CYCLES_MAX; a fn that
    waits for the device itself (boolean indexing does) is still behind
    there, and its later reps run behind the first sleep unchecked."""
    fn()
    torch.cuda.synchronize()
    times = []
    cycles = SLEEP_CYCLES
    queued_ms = None  # the host's time to queue the calls of the first rep it fell behind in
    waits = False  # fn waits for the device: no sleep holds its calls
    while len(times) < reps:
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        behind = start.query()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        if behind and not waits:
            if cycles < SLEEP_CYCLES_MAX:
                queued_ms = queued_ms or (t1 - t0) * 1e3
                cycles *= 2
                continue
            waits, cycles = True, SLEEP_CYCLES
        times.append(start.elapsed_time(end) / calls)
    if cycles > SLEEP_CYCLES:
        log(f"median_ms: the host took {queued_ms:.3f} ms to queue {calls} calls, longer than a "
            f"{SLEEP_CYCLES}-cycle sleep held the card; timed behind {cycles} cycles")
    return statistics.median(times)


def kernel_ms(torch, fn, name: str, calls: int = 20):
    """Device time of one launch of the kernel whose name contains `name`
    (fn launches it once a call), by torch.profiler: the mean over the
    launches it recorded, since it may drop some records; None where it
    saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if name in e.key]
    n = sum(e.count for e in seen)
    if n and n != calls:
        log(f"kernel_ms: torch.profiler recorded {n} launches of {name} in {calls} calls")
    return sum(e.device_time_total for e in seen) / n / 1000 if n else None


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


def _merge_counted(np, a, b):
    """Two sorted-unique (vals, counts) runs as one, counts of shared
    values summed: a stable argsort of the two runs side by side."""
    v = np.concatenate([a[0], b[0]])
    c = np.concatenate([a[1], b[1]])
    order = np.argsort(v, kind="stable")
    v, c = v[order], c[order]
    heads = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
    return v[heads], np.add.reduceat(c, heads) if heads.shape[0] else c


def oracle_reads_counts(np, codec, path: Path, k: int = 31, read_len: int = 150, workers: int = 8):
    """Exact canonical k-mer counts of a write_reads_fastq file, with numpy
    alone: its rows have one width, so each block of reads is a matrix
    whose windows are read column by column (codec.canonical_u64 for the
    canonical value), sorted and run-length encoded on a thread (numpy
    releases the GIL), and the runs merged pairwise."""
    from concurrent.futures import ThreadPoolExecutor

    head_w = 12
    row_w = head_w + read_len + 3 + read_len + 1
    rows = np.memmap(path, np.uint8, mode="r").reshape(-1, row_w)
    lut = np.full(256, 255, np.uint8)
    lut[np.frombuffer(BASES, np.uint8)] = np.arange(4, dtype=np.uint8)
    nwin = read_len - k + 1

    def block(lo_hi):
        seq = lut[np.asarray(rows[lo_hi[0] : lo_hi[1], head_w : head_w + read_len])]
        c64 = np.where(seq > 3, 0, seq).astype(np.uint64)
        vals = np.zeros((seq.shape[0], nwin), np.uint64)
        for j in range(k):
            vals = (vals << np.uint64(2)) | c64[:, j : j + nwin]
        bad = np.concatenate([np.zeros((seq.shape[0], 1), np.int64), np.cumsum(seq > 3, axis=1)], axis=1)
        keys = np.sort(codec.canonical_u64(vals[(bad[:, k:] - bad[:, :-k]) == 0], k))
        heads = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
        return keys[heads], np.diff(np.append(heads, keys.shape[0])).astype(np.int64)

    n = rows.shape[0]
    step = -(-n // (4 * workers))
    with ThreadPoolExecutor(workers) as pool:
        runs = list(pool.map(block, [(lo, min(n, lo + step)) for lo in range(0, n, step)]))
        while len(runs) > 1:
            pairs = [(runs[i], runs[i + 1]) for i in range(0, len(runs) - 1, 2)]
            merged = list(pool.map(lambda ab: _merge_counted(np, *ab), pairs))
            runs = merged + ([runs[-1]] if len(runs) % 2 else [])
    return runs[0]


def histogram_bytes(np, counts) -> bytes:
    """`MULTIPLICITY\tDISTINCT\n` lines over every counted k-mer."""
    m, f = np.unique(counts, return_counts=True)
    return "".join(f"{a}\t{b}\n" for a, b in zip(m.tolist(), f.tolist())).encode()


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


# kernels held to zero spill bytes (the redesigned K1-K4)
NO_SPILL = ("extract_kernel", "merge_kernel", "compact_kernel", "cluster_sort_kernel")


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


K3_TILE = 2048  # elements a block of csrc/compact.cu ranks
K3_SIZES = (0, 1, K3_TILE - 1, K3_TILE + 1, 1 << 22, 1 << 24, 1 << 25)
K3_DENSITIES = (0.0, 0.03, 0.5, 0.97, 1.0)
K3_DESTS = (1, 2, 3, 4, 5, 8)  # 5: one past a group of four destinations
K3_REPEATS = 20


def k3_keys(torch, dev, n: int, gen):
    """n random int64 keys, 5 % of them SENTINEL_KEY and 1 % the k = 32
    key of T*40 (A^32, INT64_MIN)."""
    from orion_kmer_tpu_torch.keys import SENTINEL_KEY

    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), device=dev, generator=gen)
    u = torch.rand(n, device=dev, generator=gen)
    keys[u < 0.05] = SENTINEL_KEY
    keys[u > 0.99] = -(1 << 63)
    return keys


def k3_outputs(outs, counts):
    """The kept prefix of every output of a K3 mode, and its counts."""
    cs = counts.reshape(-1).tolist()
    if len(cs) == 1:
        cs = cs * len(outs)
    return [o[:c] for o, c in zip(outs, cs)] + [counts.reshape(-1)]


def k3_run(torch, what: str, kernel, plain, *args):
    """kernel(*args) against plain(*args), then K3_REPEATS - 1 more runs,
    each equal to the first byte for byte (a race in the status words
    would show here)."""
    first = k3_outputs(*kernel(*args))
    want = k3_outputs(*plain(*args))
    check(len(first) == len(want) and all(torch.equal(a, b) for a, b in zip(first, want)), f"K3 {what} == plain")
    for _ in range(K3_REPEATS - 1):
        again = k3_outputs(*kernel(*args))
        check(all(torch.equal(a, b) for a, b in zip(first, again)), f"K3 {what}: every run equals the first")


def k3_exhaustive(np, torch, codec, dev, gen) -> int:
    """Every K3 mode against its plain version: n around the tile and at
    the main path's sizes, each also as a view that is not 16-byte
    aligned; every density for the masks, the positions mode with and
    without a limit, the route for every S of K3_DESTS, and the k = 32
    T*40 batch through K1.  Returns the number of cases."""
    from orion_kmer_tpu_torch.host import pack_for_transfer
    from orion_kmer_tpu_torch.ops import compact, count, extract

    cases = 0
    for n in K3_SIZES:
        for offset in (0, 1):
            keys = k3_keys(torch, dev, n + offset, gen)[offset:]
            x1 = k3_keys(torch, dev, n + offset, gen)[offset:]
            at = f"n = {n}{' (misaligned view)' if offset else ''}"
            for n_dest in K3_DESTS:
                k3_run(torch, f"route {at}, S = {n_dest}", compact.partition, compact.partition_plain, keys, n_dest)
                cases += 1
            limit = torch.tensor(n // 2 + 1, device=dev)
            for density in K3_DENSITIES:
                keep = (torch.rand(n + offset, device=dev, generator=gen) < density)[offset:]
                what = f"{at}, density {density}"
                k3_run(torch, f"one plane {what}", compact.compact, compact.compact_plain, [keys], keep)
                k3_run(torch, f"two planes {what}", compact.compact, compact.compact_plain, [keys, x1], keep)
                k3_run(torch, f"positions {what}", compact.compact_positions, compact.compact_positions_plain, keys, keep)
                k3_run(torch, f"positions {what}, limit {n // 2 + 1}", compact.compact_positions,
                       compact.compact_positions_plain, keys, keep, limit)
                cases += 4
            del keys, x1, keep
    lanes, inv = pack_for_transfer(codec.seq_to_codes(b"T" * 40), 64)
    tkeys, tn = extract.extract_keys(
        torch.from_numpy(lanes.view(np.int32)).to(dev), torch.from_numpy(inv.view(np.int32)).to(dev), 32, 40)
    for n_dest in K3_DESTS:
        k3_run(torch, f"route of T*40 at k = 32, S = {n_dest}", compact.partition, compact.partition_plain, tkeys, n_dest)
        cases += 1
    ukeys, ucnt = count.rle_sorted(torch.sort(tkeys).values, tn)
    check(ukeys.tolist() == [-(1 << 63)] and ucnt.tolist() == [9], "rle_sorted of T*40 at k = 32: one key, 9 times")
    torch.cuda.synchronize()
    log(f"K3 every mode == plain and identical over {K3_REPEATS} runs: {cases} cases, n in {K3_SIZES} "
        f"(aligned and not), densities {K3_DENSITIES}, S in {K3_DESTS}, keys with the sentinel and A^32")
    return cases


K3_FLUSH = 1 << 28  # the flush's run: FLUSH_WINDOWS sorted keys
K3_FOLD = 49_000_000  # combine_sorted_unique's fold: a ~40 M-key table and a ~9 M-key flush
K3_FLUSH_TAIL = 4096  # sentinel entries past n_valid at the end of the flush's run


def k3_flush_run(torch, dev, gen):
    """A sorted K3_FLUSH-key run as the flush hands it to rle_sorted: about
    one key in ten a head, the last K3_FLUSH_TAIL entries SENTINEL_KEY past
    n_valid.  Returns (run, heads, n_valid)."""
    from orion_kmer_tpu_torch.keys import SENTINEL_KEY

    n = K3_FLUSH
    run = torch.sort(torch.randint(0, n // 10, (n,), device=dev, generator=gen)).values
    run[-K3_FLUSH_TAIL:] = SENTINEL_KEY
    heads = torch.ones(n, dtype=torch.bool, device=dev)
    torch.ne(run[1:], run[:-1], out=heads[1:])
    return run, heads, torch.tensor(n - K3_FLUSH_TAIL, device=dev)


def k3_main_path_sizes(torch, dev, gen) -> int:
    """K3 at the largest sizes the main path gives it, each case against
    its plain version and K3_REPEATS times byte for byte: positions with a
    limit over the flush's 2^28-key run (its heads, and a density of 0.5
    that stages every tile), two planes at the fold's 49 M elements, and
    the flush's whole rle_sorted against torch.unique_consecutive.
    Returns the number of cases."""
    from orion_kmer_tpu_torch.ops import compact, count

    run, heads, n_valid = k3_flush_run(torch, dev, gen)
    k3_run(torch, "positions over the flush's 2^28-key run, its heads, limit n_valid", compact.compact_positions,
           compact.compact_positions_plain, run, heads, n_valid)
    half = torch.rand(K3_FLUSH, device=dev, generator=gen) < 0.5
    k3_run(torch, "positions, 2^28, density 0.5, limit 2^28 - 1000", compact.compact_positions,
           compact.compact_positions_plain, run, half, torch.tensor(K3_FLUSH - 1000, device=dev))
    del half
    ukeys, ucnt = count.rle_sorted(run, n_valid)
    wkeys, wcnt = torch.unique_consecutive(run[: K3_FLUSH - K3_FLUSH_TAIL], return_counts=True)
    check(torch.equal(ukeys, wkeys) and torch.equal(ucnt, wcnt),
          "rle_sorted of the flush's 2^28-key run == torch.unique_consecutive")
    del run, heads, ukeys, ucnt, wkeys, wcnt
    x0, x1 = k3_keys(torch, dev, K3_FOLD, gen), k3_keys(torch, dev, K3_FOLD, gen)
    for density in K3_DENSITIES[1:-1]:
        keep = torch.rand(K3_FOLD, device=dev, generator=gen) < density
        k3_run(torch, f"two planes, {K3_FOLD} (the fold), density {density}", compact.compact, compact.compact_plain,
               [x0, x1], keep)
    del x0, x1, keep
    torch.cuda.synchronize()
    cases = 2 + len(K3_DENSITIES[1:-1])
    log(f"K3 at the main path's largest sizes == plain and identical over {K3_REPEATS} runs: {cases} cases "
        f"(positions over a 2^28-key flush run, two planes at {K3_FOLD}); rle_sorted of the run == "
        "torch.unique_consecutive")
    return cases


def k3_mask_bytes(keep, planes_read: int, planes_written: int):
    """Bytes a mask mode of K3 must move for this keep (its length a
    multiple of 4): the flags, every 32-byte sector of each read plane that
    holds a kept element (the least the card reads from device memory), and
    the kept elements of each written plane.  Also the bytes if every
    element of each read plane is read, for comparison."""
    n, m = keep.shape[0], int(keep.sum())
    sectors = int(keep.view(-1, 4).any(1).sum())
    written = m * 8 * planes_written
    return n + sectors * 32 * planes_read + written, n * (1 + 8 * planes_read) + written


def k3_time(torch, fn, plain, library, library_name, n_bytes) -> dict:
    """One K3 shape's record: fn's device time (and the kernel alone, by
    torch.profiler), the plain version's, the library call's, the bound.
    n_bytes: the bytes the shape must move, or that and the bytes with
    every element read (k3_mask_bytes)."""
    need, all_read = n_bytes if isinstance(n_bytes, tuple) else (n_bytes, None)
    row = dict(ms=median_ms(torch, fn), kernel_alone_ms=kernel_ms(torch, fn, "compact_kernel"),
               plain_ms=median_ms(torch, plain), library=library_name,
               library_ms=median_ms(torch, library) if library else None, bound_ms=bound_ms(need))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    if all_read is not None:
        row["bound_every_element_read_ms"] = bound_ms(all_read)
    return row


def k2_tiles() -> tuple:
    """Outputs a block of csrc/merge.cu merges, keys only and with a
    payload: kThreads * kItemsKeys and kThreads * kItemsPayload."""
    src = (ROOT / "orion_kmer_tpu_torch" / "csrc" / "merge.cu").read_text()
    threads, keys, payload = (int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
                              for c in ("kThreads", "kItemsKeys", "kItemsPayload"))
    return threads * keys, threads * payload


K2_REPEATS = 20
K2_FOLD = (40_000_000, 9_000_000)  # combine_sorted_unique's fold: a ~40 M-key table and a ~9 M-key flush
K2_JOIN = (11_000_000, 1 << 24)  # setops._merged: the DB of three references and a 2^24-window query batch


def k2_call(mode, args, plain=False):
    """K2 in one mode, or its plain version: the merged keys, and the
    payload or (for the fold) the sums and the keep mask."""
    from orion_kmer_tpu_torch.ops import merge

    a, b, pa, pb = args
    if mode == "fold":
        if not plain:
            return merge.merge_combine(a, b, pa, pb)
        keys, cnt = merge.merge_plain(a, b, pa, pb)
        return (keys, *merge.combine_merged_plain(keys, cnt))
    fn = merge.merge_plain if plain else merge.merge
    keys, payload = fn(a, b, pa, pb) if mode == "payload" else fn(a, b)
    return (keys,) if payload is None else (keys, payload)


def k2_run(torch, what: str, mode: str, args) -> float:
    """K2 against its plain version, then K2_REPEATS - 1 more runs, each
    equal to the first byte for byte.  Returns the largest difference
    from the plain version (every output, the keep mask as 0/1)."""
    first = k2_call(mode, args)
    want = k2_call(mode, args, plain=True)
    check(len(first) == len(want), f"K2 {what}: as many outputs as plain")
    err = max(max_abs_err(torch, g, w) for g, w in zip(first, want))
    check(err == 0, f"K2 {what} == plain")
    for _ in range(K2_REPEATS - 1):
        check(all(torch.equal(g, f) for g, f in zip(k2_call(mode, args), first)), f"K2 {what}: every run equals the first")
    return err


def k2_sides(torch, dev, gen, kind: str, na: int, nb: int, unique: bool):
    """Two ascending int64 runs (sorted unique for the fold): random keys
    from a narrow range, equal keys across tile edges (for the fold the same
    keys on both sides), one run wholly below the other, or long
    SENTINEL_KEY tails."""
    from orion_kmer_tpu_torch.keys import SENTINEL_KEY

    def side(m, lo):
        if kind == "ties":
            v = torch.arange(m, device=dev) if unique else torch.full((m,), 7, device=dev)
        elif kind == "random":
            v = torch.randint(0, max(3 * (na + nb), 2) if unique else max(m // 3, 2), (m,), device=dev, generator=gen)
            v = torch.sort(v).values
            if unique:
                v = v * (na + nb + 1) + torch.arange(m, device=dev)  # distinct, still ascending
        else:
            v = lo + (torch.arange(m, device=dev) * 2 if unique else torch.arange(m, device=dev) // 3)
            if kind == "sentinel tails" and m:
                v[m - (1 if unique else 2 * m // 5 + 1):] = SENTINEL_KEY
        return v.to(torch.int64)

    lo_a = 10 * (nb + 1) if kind == "b below a" else 0
    lo_b = 10 * (na + 1) if kind == "a below b" else 0
    return side(na, lo_a), side(nb, lo_b)


def k2_edges(torch, dev, gen) -> float:
    """Every K2 mode against its plain version at lengths around its tile
    and at (2^20 + 5, 333,333), for every kind of k2_sides, each case
    K2_REPEATS times byte for byte.  Returns the largest difference."""
    lengths = [(0, 0), (0, 1), (1, 0), (1, 1)] + [
        x for t in k2_tiles() for x in ((t - 1, 0), (0, t + 1), (t - 1, t + 1), (t + 1, t - 1), (3 * t, 2 * t + 1))
    ] + [((1 << 20) + 5, 333_333)]
    kinds = ("random", "ties", "a below b", "b below a", "sentinel tails")
    cases, err = 0, 0.0
    for na, nb in lengths:
        for kind in kinds:
            for mode in ("keys", "payload", "fold"):
                a, b = k2_sides(torch, dev, gen, kind, na, nb, mode == "fold")
                if mode == "keys":
                    pa = pb = None
                elif mode == "payload":
                    pa, pb = torch.arange(na, device=dev), na + torch.arange(nb, device=dev)
                else:
                    pa = torch.randint(1, 1 << 40, (na,), device=dev, generator=gen)
                    pb = torch.randint(1, 1 << 40, (nb,), device=dev, generator=gen)
                err = max(err, k2_run(torch, f"{mode}, {na} + {nb}, {kind}", mode, (a, b, pa, pb)))
                cases += 1
    torch.cuda.synchronize()
    log(f"K2 every mode == plain and identical over {K2_REPEATS} runs: {cases} cases, lengths {lengths}, "
        f"kinds {kinds}")
    return err


K2_FOREST = (  # (log2 of a side, the runs end in SENTINEL_KEY tails, what)
    (24, False, "forest; a shard's last level"),
    (21, False, "a shard's first level"),
    (22, False, "a shard's second level"),
    (23, False, "a shard's third level"),
    (25, True, "forest, second level"),
    (26, True, "forest, third level"),
    (27, True, "the flush's last merge"),
)


def k2_shapes(torch, dev, gen):
    """K2's shapes on the main path: (name, mode, (a, b, pa, pb), bytes it
    must move).  The forest: two sorted runs with many duplicates at every
    level of a flush's binary counter (K2_FOREST: the single table merges
    2^24-key batch runs into 2^25, ..., up to 2^27 + 2^27; each of four
    shards merges runs of its routed keys, ~2^21 a batch, up to ~2^24 +
    2^24); the single table's runs end in SENTINEL_KEY, a third of each
    run (windows no read covers and the bucket's padding: 0.5 Gbp of 150
    bp reads is 400 M windows in 36 runs of 2^24); the fold: a
    sorted-unique counted table and a flush's table sharing about half of
    the flush's keys; the join: the DB with its -1 - row tags and sorted
    queries, half of them DB keys, tagged with their positions."""
    from orion_kmer_tpu_torch.keys import SENTINEL_KEY

    def randint(lo, hi, m):
        return torch.randint(lo, hi, (m,), device=dev, generator=gen)

    def run(m, tail):
        v = torch.sort(randint(-m // 4, m // 4, m)).values
        if tail:
            v[m - m // 3:] = SENTINEL_KEY
        return v

    out = []
    for e, tail, what in K2_FOREST:
        m = 1 << e
        out.append((f"keys, 2^{e} + 2^{e}{', sentinel tails' if tail else ''} ({what})", "keys",
                    (run(m, tail), run(m, tail), None, None), 2 * m * 16))
    for scale, what in ((1, "the fold"), (4, "a shard's fold")):
        na, nb = K2_FOLD[0] // scale, K2_FOLD[1] // scale
        ta = torch.unique(randint(-(1 << 40), 1 << 40, na))
        shared = ta[randint(0, ta.shape[0], nb // 2)]
        tb = torch.unique(torch.cat([shared, randint(-(1 << 40), 1 << 40, nb - nb // 2)]))
        ca, cb = randint(1, 1000, ta.shape[0]), randint(1, 1000, tb.shape[0])
        out.append((f"fold, {ta.shape[0]} + {tb.shape[0]} with counts ({what})", "fold", (ta, tb, ca, cb),
                    (ta.shape[0] + tb.shape[0]) * 33))
    db = torch.unique(randint(-(1 << 40), 1 << 40, K2_JOIN[0]))
    nq = K2_JOIN[1]
    q = torch.sort(torch.cat([db[randint(0, db.shape[0], nq // 2)], randint(-(1 << 40), 1 << 40, nq - nq // 2)])).values
    tags = (-1 - torch.arange(db.shape[0], device=dev), torch.arange(nq, device=dev))
    out.append((f"payload, {db.shape[0]} DB keys + 2^24 queries with tags (the join)", "payload", (db, q, *tags),
                (db.shape[0] + nq) * 32))
    return out


def k2_rows(torch, dev, gen) -> dict:
    """K2 at each main-path shape: exact against its plain version over
    K2_REPEATS runs, then its time, the kernel alone, the plain version's,
    the library's (a stable torch.sort of the concatenated keys), the bound;
    then the whole combine_sorted_unique at the fold's size.  Prints
    `K2 rows: {...}` and returns the record of the 2^24 + 2^24 forest merge
    for the kernels line."""
    from orion_kmer_tpu_torch.ops import compact, count, merge

    rows = {}
    err = 0.0
    shapes = k2_shapes(torch, dev, gen)
    for what, mode, args, n_bytes in shapes:
        err = max(err, k2_run(torch, what, mode, args))
        a, b = args[:2]
        row = dict(ms=median_ms(torch, lambda: k2_call(mode, args)),
                   kernel_alone_ms=kernel_ms(torch, lambda: k2_call(mode, args), "merge_kernel"),
                   plain_ms=median_ms(torch, lambda: k2_call(mode, args, plain=True), calls=5),
                   library="torch.sort(cat, stable=True)" + (" (keys only)" if mode != "keys" else ""),
                   library_ms=median_ms(torch, lambda: torch.sort(torch.cat([a, b]), stable=True), calls=5),
                   bound_ms=bound_ms(n_bytes))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows[what] = row
        log(f"K2 {what}: {row['ms']:.4f} ms (alone {row['kernel_alone_ms']}), plain {row['plain_ms']:.4f}, "
            f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ({100 * row['share_of_bound']:.0f} %)")
    # the whole fold: K2's fold mode, then K3 over keys and sums, one host sync
    what, _, args, _ = next(s for s in shapes if s[0].endswith("(the fold)"))
    keys, cnt = merge.merge_plain(*args)
    summed, keep = merge.combine_merged_plain(keys, cnt)
    (wk, wc), _ = compact.compact_plain([keys, summed], keep)
    got = count.combine_sorted_unique(args[0], args[2], args[1], args[3])
    err = max(err, max_abs_err(torch, got[0], wk), max_abs_err(torch, got[1], wc))
    check(err == 0, "combine_sorted_unique at the fold's size == plain")
    before = (merge.launches, compact.launches)
    count.combine_sorted_unique(args[0], args[2], args[1], args[3])
    check((merge.launches, compact.launches) == (before[0] + 1, before[1] + 1),
          "combine_sorted_unique: one K2 launch, then one K3 launch")
    rows["combine_sorted_unique, " + what.split(", ", 1)[1]] = dict(
        ms=median_ms(torch, lambda: count.combine_sorted_unique(args[0], args[2], args[1], args[3]), calls=5))
    del shapes, keys, cnt, summed, keep, wk, wc, got
    log(f"K2 rows: {json.dumps(rows)}")
    first = rows[next(iter(rows))]
    return dict(ms=first["ms"], plain_ms=first["plain_ms"], library_ms=first["library_ms"], bound_ms=first["bound_ms"],
                max_abs_err=err)


def phase_kernels(np, torch, codec, dev, rng):
    """Each kernel against its plain version on the card; returns, per
    kernel, its record for the JSON line: kernel, plain and library times,
    the bound from the bytes it must move, and the largest error."""
    from orion_kmer_tpu_torch.host import pack_for_transfer
    from orion_kmer_tpu_torch.keys import SENTINEL_KEY
    from orion_kmer_tpu_torch.ops import compact, extract, merge, radix, sketch, sort
    from orion_kmer_tpu_torch.ops import hash as hash_ops
    from orion_kmer_tpu_torch.parallel import sharded

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
    # the sketch's hash and keep chain (torch ops, no kernel of its own) on
    # K1's keys of the 2^24 batch: its device time per batch, beside the
    # bytes it must move (8 B in, a 1 B mask out per position)
    keys, _ = extract.extract_keys(L, I, 31, n - 7)
    t_h = median_ms(torch, lambda: sketch.keep_mask(keys, hash_ops.splitmix64(keys), 1000))
    log(f"sketch hash-and-keep chain, 2^24 keys, k = 31, scaled = 1000: {t_h:.4f} ms per batch, "
        f"bound {bound_ms(n * 9):.4f} ms")

    # the batch radix sort on count's batch: the K1 keys of the 2^24 batch
    # at k = 31, on their 62 bits as count sorts them (and on all 64),
    # against its plain version, bit for bit, 20 times; its bound is 16 B a
    # key a pass
    want = radix.sort_keys_plain(keys)
    err = max(max_abs_err(torch, radix.sort_keys(keys, 64), want), *(
        max_abs_err(torch, radix.sort_keys(keys, 62), want) for _ in range(20)))
    check(err == 0, "the batch radix sort agrees with torch.sort")
    t_k = median_ms(torch, lambda: radix.sort_keys(keys, 62))
    t_p = median_ms(torch, lambda: radix.sort_keys_plain(keys))
    t_l = median_ms(torch, lambda: torch.sort(keys))
    t_b = bound_ms(16 * radix.passes(62) * n)
    log(f"batch radix sort, 2^24 K1 keys at k = 31 on 62 bits ({radix.passes(62)} passes): sort_keys "
        f"{t_k:.4f} ms, plain torch.sort(keys).values {t_p:.4f} ms, library torch.sort {t_l:.4f} ms, "
        f"bound {t_b:.4f} ms")
    rec["radix"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=t_b, max_abs_err=err)
    del keys, want
    torch.cuda.synchronize()

    # K2: every mode at edge lengths, 20 runs each byte for byte; then each
    # shape the main path gives it, timed (k2_rows); then the whole fold
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))
    err = k2_edges(torch, dev, gen)
    rec["K2"] = k2_rows(torch, dev, gen)
    rec["K2"]["max_abs_err"] = max(err, rec["K2"]["max_abs_err"])
    torch.cuda.synchronize()

    # K3: every mode against its plain version, each case 20 times and byte
    # for byte against its first run (k3_exhaustive); then the main path's
    # shapes, timed
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))
    k3_exhaustive(np, torch, codec, dev, gen)
    k3_main_path_sizes(torch, dev, gen)
    rows = {}
    n = 1 << 25
    x0, x1 = k3_keys(torch, dev, n, gen), k3_keys(torch, dev, n, gen)
    err = 0.0
    for density in (0.03, 0.5, 0.97):  # combine_sorted_unique's two planes
        keep = torch.rand(n, device=dev, generator=gen) < density
        (g0, g1), gn = compact.compact([x0, x1], keep)
        (p0, p1), pn = compact.compact_plain([x0, x1], keep)
        m = int(pn)
        check(int(gn) == m, "K3 kept count")
        err = max(err, max_abs_err(torch, g0[:m], p0), max_abs_err(torch, g1[:m], p1))
        rows[f"two planes, 2^25, density {density}"] = k3_time(
            torch, lambda: compact.compact([x0, x1], keep), lambda: compact.compact_plain([x0, x1], keep),
            lambda: (x0[keep], x1[keep]), "x0[keep], x1[keep]", k3_mask_bytes(keep, 2, 2))
    check(err == 0, "K3 agrees with its plain version")
    rec["K3"] = dict(rows["two planes, 2^25, density 0.5"], max_abs_err=err)
    del g0, g1, p0, p1
    # the fold's size: a ~40 M-key table and a ~9 M-key flush, nearly disjoint
    f0, f1 = k3_keys(torch, dev, K3_FOLD, gen), k3_keys(torch, dev, K3_FOLD, gen)
    keep = torch.rand(K3_FOLD, device=dev, generator=gen) < 0.97
    rows[f"two planes, {K3_FOLD} (the fold), density 0.97"] = k3_time(
        torch, lambda: compact.compact([f0, f1], keep), lambda: compact.compact_plain([f0, f1], keep),
        lambda: (f0[keep], f1[keep]), "x0[keep], x1[keep]", k3_mask_bytes(keep, 2, 2))
    del f0, f1
    # the flush's rle_sorted: the heads of its sorted 2^28-key run, before
    # n_valid (positions mode, the kernel writes the indices)
    run, heads, n_valid = k3_flush_run(torch, dev, gen)
    kept = heads & (torch.arange(K3_FLUSH, device=dev) < n_valid)
    rows["positions, 2^28 flush run, its heads (~0.1), limit n_valid (the flush's rle_sorted)"] = k3_time(
        torch, lambda: compact.compact_positions(run, heads, n_valid),
        lambda: compact.compact_positions_plain(run, heads, n_valid), None, None, k3_mask_bytes(kept, 1, 2))
    del run, heads, kept
    # membership_sorted: one plane over a merge of 2^24 DB rows and 2^24 queries
    keep = torch.rand(n, device=dev, generator=gen) < 0.5
    rows["one plane, 2^25, density 0.5"] = k3_time(
        torch, lambda: compact.compact([x0], keep), lambda: compact.compact_plain([x0], keep),
        lambda: x0[keep], "x[keep]", k3_mask_bytes(keep, 1, 1))
    # membership: a 2^24 query batch, 97 % valid (positions mode)
    n = 1 << 24
    q, keep = x0[:n], torch.rand(n, device=dev, generator=gen) < 0.97
    rows["positions, 2^24, density 0.97"] = k3_time(
        torch, lambda: compact.compact_positions(q, keep), lambda: compact.compact_positions_plain(q, keep),
        None, None, k3_mask_bytes(keep, 1, 2))
    # the sketch: the hashes of a 2^24 batch at density 1/1000 (the
    # survivors of scaled = 1000)
    keep = torch.rand(n, device=dev, generator=gen) < 1e-3
    m = int(keep.sum())
    rows[f"one plane, 2^24, density 1/1000 ({m} kept)"] = k3_time(
        torch, lambda: compact.compact([q], keep), lambda: compact.compact_plain([q], keep),
        lambda: q[keep], "x[keep]", k3_mask_bytes(keep, 1, 1))
    del x0, x1, q, keep
    torch.cuda.synchronize()

    # K4: a cluster of 1 to 8 CTAs sorts each n below, with duplicates and
    # the all-ones key that ties with its padding; timed at 2^14 and 12289
    err = 0.0
    for m in (1, 2, 3, 2047, 2048, 2049, 4097, 12289, 1 << 14):
        keys = torch.randint(-(1 << 62), 1 << 62, (m,), device=dev)
        keys[: m // 4] = keys[m // 4 : 2 * (m // 4)].clone()
        keys[0] = (1 << 63) - 1
        err = max(err, max_abs_err(torch, sort.sort_pairs(keys), torch.sort(keys).values))
        if m < 12289:
            continue
        t_k = median_ms(torch, lambda: sort.sort_pairs(keys))
        t_p = median_ms(torch, lambda: torch.sort(keys).values)
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

    # the sharded count's route step on one shard's block of a 2^24 batch
    # cut four ways: one K3 launch in route mode (owners in registers, the
    # sentinel dropped, four rows); its bound is the keys read once and
    # every valid key written once.  The plain chain is today's torch
    # version of the same step (owner chain, S masks, S keys[mask]).
    n = 1 << 22
    lanes, inv = pack_for_transfer(codec.seq_to_codes(codes[: n - 5]), n)
    keys, n_valid = extract.extract_keys(
        torch.from_numpy(lanes.view(np.int32)).to(dev), torch.from_numpy(inv.view(np.int32)).to(dev), 31, n - 7)
    valid = keys != SENTINEL_KEY
    owner = hash_ops.owner_of(keys, 4)
    before = compact.launches
    segments = sharded.route_to_owners(keys, 4)
    check(compact.launches == before + 1, "route step: one K3 launch for four destinations")
    for d, seg in enumerate(segments):
        check(torch.equal(seg, keys[valid & (owner == d)]), f"route step: destination {d} == keys[valid & (owner == d)]")
    check(sum(seg.shape[0] for seg in segments) == int(n_valid), "route step: every valid key routed once")
    for n_dest in (4, 8):
        rows[f"route, 2^22 k = 31 keys, S = {n_dest}"] = k3_time(
            torch, lambda: compact.partition(keys, n_dest), lambda: compact.partition_plain(keys, n_dest),
            None, None, n * 8 + int(n_valid) * 8)
    del keys, valid, owner, segments
    torch.cuda.synchronize()
    log(f"K3 rows: {json.dumps(rows)}")

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        kernels_on_card(np, torch, codec, torch.device("cuda", n_cards - 1), rng)
    else:
        log("one card visible: the kernels' run on another card than the current one is skipped")
    log(f"launch counters after phase 3: K1 {extract.launches} K2 {merge.launches} "
        f"K3 {compact.launches} K4 {sort.launches}")
    return rec


def kernels_on_card(np, torch, codec, dev, rng):
    """K1-K4 (K3 in every mode) against their plain versions with their
    operands on `dev` while another card is the current one: each launch
    must follow its operands (K1 also opts in to its shared memory per
    device)."""
    from orion_kmer_tpu_torch.host import pack_for_transfer
    from orion_kmer_tpu_torch.ops import compact, extract, merge, sort

    check(torch.cuda.current_device() != dev.index, f"{dev} is not the current device")
    n = 1 << 20
    codes = np.frombuffer(BASES, np.uint8)[rng.integers(0, 4, n)].copy()
    lanes, inv = pack_for_transfer(codec.seq_to_codes(codes), n)
    L = torch.from_numpy(lanes.view(np.int32)).to(dev)
    I = torch.from_numpy(inv.view(np.int32)).to(dev)
    err = 0.0
    for k in (17, 31, 32):
        gk, gn = extract.extract_keys(L, I, k, n - 3)
        pk, pn = extract.extract_keys_plain(L, I, k, n - 3)
        err = max(err, max_abs_err(torch, gk, pk), abs(int(gn) - int(pn)))
    a = torch.sort(torch.randint(-(1 << 40), 1 << 40, (n,), device=dev)).values
    b = torch.sort(torch.randint(-(1 << 40), 1 << 40, (n + 77,), device=dev)).values
    err = max(err, max_abs_err(torch, merge.merge(a, b)[0], merge.merge_plain(a, b)[0]))
    ua, ub = torch.unique(a), torch.unique(b)
    k2_run(torch, f"fold on {dev}", "fold", (ua, ub, torch.ones_like(ua), 2 * torch.ones_like(ub)))
    keep = torch.rand(n, device=dev) < 0.5
    limit = torch.tensor(n // 3, device=dev)
    for args in (([a], keep), ([a, b[:n]], keep)):
        k3_run(torch, f"on {dev}", compact.compact, compact.compact_plain, *args)
    k3_run(torch, f"positions on {dev}", compact.compact_positions, compact.compact_positions_plain, a, keep, limit)
    for n_dest in (4, 5):
        k3_run(torch, f"route on {dev}, S = {n_dest}", compact.partition, compact.partition_plain, b, n_dest)
    err = max(err, max_abs_err(torch, sort.sort_pairs(b[:12289].flip(0)), b[:12289]))
    torch.cuda.synchronize(dev)
    check(err == 0, f"K1-K4 agree with their plain versions on {dev}")
    check(torch.cuda.current_device() != dev.index, "the current device is unchanged")
    log(f"K1-K4 with operands on {dev} while cuda:{torch.cuda.current_device()} is current: exact")


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


def classify_expected(np, refs, vals, counts):
    """Per reference (sorted names) of a database: (name, k-mers in it,
    input k-mers (vals, counts) it holds, their depth sum); and over the
    union of the references, (matched, depth)."""
    in_any = np.zeros(vals.shape[0], bool)
    rows = []
    for name in sorted(refs):
        hit = np.isin(vals, refs[name])
        in_any |= hit
        rows.append((name, refs[name].shape[0], int(hit.sum()), int(counts[hit].sum())))
    return rows, int(in_any.sum()), int(counts[in_any].sum())


def check_db_result(np, res, refs, vals, counts, what):
    """One ``databases_analyzed`` entry (every reference reported, as at
    --min-coverage 0) against the oracle."""
    rows, matched, depth = classify_expected(np, refs, vals, counts)
    got = [(r["reference_name"], r["total_kmers_in_reference"], r["input_kmers_hitting_reference"],
            r["sum_depth_of_matched_kmers_in_input"]) for r in res["references"]]
    check(got == rows, f"{what}: per-reference matches and depths == oracle")
    check(res["overall_input_kmers_matched_in_db"] == matched, f"{what}: overall matched")
    check(res["overall_sum_depth_of_matched_kmers_in_input"] == depth, f"{what}: overall depth")


def check_classify(np, json_path: Path, tsv_path: Path, input_path, db_path, refs, vals, counts):
    """classify's JSON and TSV against the oracle: per reference (sorted
    names), the filtered input k-mers (vals, counts) it holds and their
    depth sum; overall, their union."""
    lines = [CLASSIFY_TSV_HEADER]
    n_in = vals.shape[0]
    rows, _, _ = classify_expected(np, refs, vals, counts)
    for name, total, matched, depth in rows:
        avg = depth / matched if matched else 0.0
        prop = matched / n_in if n_in else 0.0
        breadth = matched / total if total else 0.0
        lines.append(f"{input_path}\t{db_path}\t{name}\t{total}\t{matched}\t{depth}\t{avg:.4f}\t{prop:.4f}\t{breadth:.4f}\n")
    check(tsv_path.read_text() == "".join(lines), f"classify TSV {tsv_path.name} == oracle")
    doc = json.loads(json_path.read_text())
    check(doc["total_unique_kmers_in_input"] == n_in, "classify input k-mers after the filter")
    check_db_result(np, doc["databases_analyzed"][0], refs, vals, counts, "classify")
    return len(lines) - 1


def run_clis(jobs) -> float:
    """Run CLI calls ((args, env) pairs) as subprocesses, four at a time
    (each spends most of its wall starting Python and CUDA); returns the
    wall of the whole stage."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda job: run_cli(*job), jobs))
    return time.monotonic() - t0


def phase_exact(np, codec, work: Path, rng):
    from orion_kmer_tpu_torch.db import KmerDb

    fa = work / "big.fasta"
    records = write_multirecord_fasta(np, fa, rng, 9_000_000)
    log(f"exact run: {len(records)} records, {sum(map(len, records))} bases")
    tedge = work / "tedge.fasta"
    tedge.write_bytes(b">t\n" + b"T" * 40 + b"\n")
    small = work / "small.fasta"
    small_recs = write_multirecord_fasta(np, small, rng, 300_000)
    fq = work / "q.fastq"
    reads = write_query_reads(np, fq, rng, records)

    # stage 1: the counts and the builds, which need nothing of each other
    runs = [(k, {}) for k in (15, 21, 31, 32)]
    runs.append((31, {"ORION_KMER_BATCH": "1048576", "ORION_KMER_DEVICE_TABLE_MAX": str(1 << 21)}))
    count_out = [work / f"count_k{k}_{i}.tsv" for i, (k, _) in enumerate(runs)]
    db, small_db = work / "db.db", work / "small.db"
    wall = run_clis(
        [(["count", "-k", k, "-i", fa, "-o", out], env) for (k, env), out in zip(runs, count_out)]
        + [(["count", "-k", 32, "-i", tedge, "-o", work / "t.tsv"], {}),
           (["build", "-k", 21, "-g", fa, small, "-o", db], {}),
           (["build", "-k", 21, "-g", small, "-o", small_db], {})]
    )
    log(f"5 counts, the T*40 count and 2 builds as 8 processes, 4 at a time: {wall:.1f} s")
    oracle_tsv = {}
    for (k, env), out in zip(runs, count_out):
        if k not in oracle_tsv:
            oracle_tsv[k] = render_tsv(np, *oracle_counts(np, codec, records, k), k)
        check(out.read_bytes() == oracle_tsv[k], f"count k={k} {env} TSV == oracle")
        log(f"count k={k} {env or ''}: {oracle_tsv[k].count(10)} k-mers, byte-exact")
    check((work / "t.tsv").read_bytes() == b"A" * 32 + b"\t9\n", "T*40 at k=32")
    log("count k=32 T*40 edge: exact")

    ref = KmerDb(k=21)
    for name, recs in (("big.fasta", records), ("small.fasta", small_recs)):
        ref.add_reference(name, oracle_counts(np, codec, recs, 21)[0])
    check(db.read_bytes() == ref.to_bincode(), "build -k 21 .db == oracle round trip")
    check(KmerDb.load(db).total_unique_kmers() == ref.total_unique_kmers(), "db reload")
    log(f"build -k 21: {ref.total_unique_kmers()} unique k-mers, byte-exact")

    # stage 2: the joins on that DB
    cl_out, cl_tsv = work / "cl.json", work / "cl.tsv"
    wall = run_clis(
        [(["compare", "--db1", db, "--db2", other, "-o", work / f"cmp_{other.stem}.json"], {}) for other in (db, small_db)]
        + [(["query", "-d", db, "-r", fq, "-o", work / f"q{c}.txt", "-c", c], {}) for c in (1, 5)]
        + [(["classify", "-i", fq, "-d", db, "-o", cl_out, "--min-kmer-frequency", 2, "--output-tsv", cl_tsv], {})]
    )
    log(f"2 compares, 2 queries and classify as 5 processes, 4 at a time: {wall:.1f} s")
    union = ref.get_all_kmers_unified()
    for other, other_set in ((db, union), (small_db, ref.references["small.fasta"])):
        got = json.loads((work / f"cmp_{other.stem}.json").read_text())
        inter = int(np.intersect1d(union, other_set).shape[0])
        u = union.shape[0] + other_set.shape[0] - inter
        check(got["intersection_size"] == inter and got["union_size"] == u and got["jaccard_index"] == inter / u,
              f"compare with {other.name} == np.intersect1d")
        log(f"compare db.db {other.name}: intersection {inter}, union {u}, exact")

    hits = window_hits(np, codec, reads, 21, union)
    for c in (1, 5):
        exp = b"".join(b"q%d\n" % i for i, (r, h) in enumerate(zip(reads, hits.tolist())) if h >= c and len(r) >= 21)
        check((work / f"q{c}.txt").read_bytes() == exp, f"query -c {c} == oracle")
        log(f"query -c {c}: {exp.count(10)} of {len(reads)} reads, exact")

    vals, counts = oracle_counts(np, codec, reads, 21)
    keep = counts >= 2
    n_refs = check_classify(np, cl_out, cl_tsv, fq, db, ref.references, vals[keep], counts[keep])
    log(f"classify -m 2: {int(keep.sum())} input k-mers, {n_refs} references, exact")
    phase_exact_small_batches(np, codec, work, reads[:10], db, union)
    return oracle_tsv[21]


def phase_exact_small_batches(np, codec, work: Path, tiny_reads, db, union):
    """Phase 4, stage 3: `count`, `query -c 1` and `sketch` at
    ORION_KMER_BATCH = k - 1, where every path takes batches of k
    positions: a 24-base record at k = 9 (the reads: it and T x 24), and 10
    of the query reads at k = 21 against the phase's DB, each against the
    oracle."""
    from orion_kmer_tpu_torch.ops.hash import splitmix64_np

    seq = b"ACGTACGTACGTACGTACGTAAAC"
    fx, fx_reads, fx_db, tiny = work / "fx.fasta", work / "fx_reads.fasta", work / "fx.db", work / "tiny.fq"
    fx.write_bytes(b">a\n" + seq + b"\n")
    fx_reads.write_bytes(b">r1\n" + seq + b"\n>r2\n" + b"T" * 24 + b"\n")
    tiny.write_bytes(b"".join(b"@q%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)) for i, r in enumerate(tiny_reads)))
    run_cli(["build", "-k", 9, "-g", fx, "-o", fx_db])
    jobs = []
    for k, reads_in, query_db, tag in ((9, fx, fx_db, "fx"), (21, tiny, db, "tiny")):
        env = {"ORION_KMER_BATCH": str(k - 1)}
        query_in = fx_reads if tag == "fx" else tiny
        jobs += [(["count", "-k", k, "-i", reads_in, "-o", work / f"{tag}.tsv"], env),
                 (["query", "-d", query_db, "-r", query_in, "-c", 1, "-o", work / f"{tag}.ids"], env),
                 (["sketch", "-k", k, "--scaled", 2, "-i", reads_in, "-o", work / f"{tag}.sig"], env)]
    wall = run_clis(jobs)
    log(f"count, query -c 1 and sketch at ORION_KMER_BATCH = k - 1, k = 9 and 21, as 6 processes: {wall:.1f} s")
    for k, records, tag in ((9, [seq], "fx"), (21, tiny_reads, "tiny")):
        check((work / f"{tag}.tsv").read_bytes() == render_tsv(np, *oracle_counts(np, codec, records, k), k),
              f"count k={k} at a batch of k - 1 == oracle")
        sep = np.full(k - 1, 255, np.uint8)
        codes = np.concatenate([x for r in records for x in (codec.seq_to_codes(r), sep)])
        h, a = sketch_oracle(np, codec, splitmix64_np, codes, k, 2)
        sk = json.loads((work / f"{tag}.sig").read_text())["sketches"][0]
        check(sig_hashes(sk) == h.tolist() and sk["abundances"] == a.tolist(), f"sketch k={k} at a batch of k - 1 == oracle")
    check((work / "fx.tsv").stat().st_size == 60, "count k=9 of the 24-base record: 60 bytes")
    check((work / "fx.ids").read_bytes() == b"r1\n", "query -c 1 k=9 at a batch of 8 == r1")
    hits = window_hits(np, codec, tiny_reads, 21, union)
    want = b"".join(b"q%d\n" % i for i, (r, h) in enumerate(zip(tiny_reads, hits.tolist())) if h >= 1 and len(r) >= 21)
    check((work / "tiny.ids").read_bytes() == want, "query -c 1 k=21 at a batch of 20 == oracle")
    log(f"batches of k - 1: count, query ({want.count(10)} of {len(tiny_reads)} reads) and sketch at k = 9 and 21, exact")


def parse_rates(fq: Path, thread_counts, k: int = 31) -> dict:
    """Positions/s of the streaming native parse alone (``host.native_chunks``:
    read, parse on T parser threads, check and order the pieces) at each
    thread count: {T: {positions, s, M positions/s, wrong guesses, peak
    pieces}}."""
    from orion_kmer_tpu_torch import host

    rates = {}
    for t in thread_counts:
        stats = host.ParseStats()
        t0 = time.monotonic()
        positions = sum(p.codes.shape[0] for p in host.native_chunks(fq, k, threads=t, stats=stats))
        wall = time.monotonic() - t0
        rates[t] = {"positions": positions, "s": round(wall, 4), "M_per_s": round(positions / wall / 1e6, 3),
                    "misses": stats.misses, "peak_pieces": stats.peak if t > 1 else 1}
    return rates


# the port's CLI, with the process's resident set read every 10 ms from
# /proc/self/statm (a fork's rusage would count the parent's pages too,
# and some kernels give no VmHWM); its peak in bytes goes to argv[1]
_CLI_PEAK = (
    "import os, sys, threading, time\n"
    "from orion_kmer_tpu_torch.cli import main\n"
    "page, peak, done = os.sysconf('SC_PAGE_SIZE'), [0], threading.Event()\n"
    "def sample():\n"
    "    while not done.is_set():\n"
    "        try:\n"
    "            with open('/proc/self/statm') as f:\n"
    "                peak[0] = max(peak[0], int(f.read().split()[1]) * page)\n"
    "        except OSError:\n"
    "            return\n"
    "        time.sleep(0.01)\n"
    "t = threading.Thread(target=sample, daemon=True)\n"
    "t.start()\n"
    "rc = main(sys.argv[2:])\n"
    "done.set()\n"
    "t.join()\n"
    "with open(sys.argv[1], 'w') as f:\n"
    "    f.write(str(peak[0]))\n"
    "sys.exit(rc)\n"
)


def cli_subprocess(argv, log_path: Path):
    """The port's CLI in a fresh process: (wall s with process start, peak
    RSS bytes of that process, sampled every 10 ms)."""
    peak_path = log_path.with_suffix(".peak")
    t0 = time.monotonic()
    with open(log_path, "wb") as err:
        rc = subprocess.run([sys.executable, "-c", _CLI_PEAK, str(peak_path), *map(str, argv)],
                            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err).returncode
    wall = time.monotonic() - t0
    check(rc == 0, f"{argv}: exit code ({log_path.read_text()[-2000:]})")
    return wall, int(peak_path.read_text()) or None  # None: /proc/self/statm could not be read


def tsv_matches(np, path: Path, vals, counts, k: int, rows: int = 1 << 21) -> bool:
    """Whether the file at ``path`` is render_tsv of (vals, counts),
    compared a slice of ``rows`` rows at a time (the whole oracle of a
    large table would not fit in memory at once)."""
    with open(path, "rb") as f:
        for lo in range(0, vals.shape[0], rows):
            want = render_tsv(np, vals[lo : lo + rows], counts[lo : lo + rows], k)
            if f.read(len(want)) != want:
                return False
        return f.read(1) == b""


def tail_split(np, torch, dev, vals, counts, work: Path, thread_counts) -> dict:
    """The tail of `count -k 31 -m 2 --histogram` after its table, in
    seconds: the table's fetch from the card (``staging.fetch_table`` of
    the table put back on ``dev``; cold, then warm), then at each -t of ``thread_counts``
    the fused pass alone (``native.render_counts`` of the TSV into no
    file, with the histogram), the histogram's lines and the whole write
    of both files (``commands.count.write_counts_tsv``)."""
    from orion_kmer_tpu_torch.commands import count as count_cmd
    from orion_kmer_tpu_torch.ingest import native
    from orion_kmer_tpu_torch.keys import keys_from_u64
    from orion_kmer_tpu_torch.staging import fetch_table

    keys, cnt = keys_from_u64(vals).to(dev), torch.from_numpy(counts).to(dev)
    # cold: torch's cache of pinned host memory emptied first, as a fresh
    # CLI process has it (where this torch can empty it); warm: cached
    empty_host_cache = (getattr(torch._C, "_host_emptyCache", None)
                        or getattr(torch._C, "_accelerator_emptyHostCache", None))
    out = {"rows": int(vals.shape[0]), "host_cache_emptied": empty_host_cache is not None and dev.type == "cuda",
           "fetch_s": {}, "threads": {}}
    for name in ("cold", "warm"):
        if name == "cold" and out["host_cache_emptied"]:
            empty_host_cache()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = fetch_table(keys, cnt)
        out["fetch_s"][name] = time.monotonic() - t0
        check(np.array_equal(got[0], vals) and np.array_equal(got[1], counts), "fetch_table == the table")
        del got
    del keys, cnt
    for t in thread_counts:
        os.environ["ORION_KMER_THREADS"] = str(t)
        row = {}
        t0 = time.monotonic()
        hist = native.render_counts(lambda b: None, vals, counts, 31, 2, True, t)
        row["fused_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        with open(work / "tail_lines.hist", "w") as f:
            count_cmd._write_histogram_rows(f, *hist)
        row["histogram_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        count_cmd.write_counts_tsv(work / "tail.tsv", vals, counts, 31, 2, work / "tail.hist")
        row["write_s"] = time.monotonic() - t0
        out["threads"][t] = row
    (work / "tail.tsv").unlink()
    return out


def phase_realistic(np, torch, codec, work: Path, rng, gbp: float, dev):
    """Phase 5: the main path, `count -k 31 -m 2 --histogram` of the
    E. coli-like reads, its TSV and histogram byte-equal to the numpy
    oracle; and the host stage beside it: the parse's positions/s at 1 to
    16 parser threads, the warm ``engine.count_file`` and the CLI's wall
    (a fresh process, with its peak RSS) at -t 1 and at the default, the
    device busy share at the default, every output equal."""
    from torch.profiler import ProfilerActivity, profile

    from orion_kmer_tpu_torch import cli, engine, host

    fq = work / "reads.fastq"
    t0 = time.monotonic()
    n_reads, n_windows, genome, read_sample = write_reads_fastq(np, fq, rng, gbp)
    log(f"realistic run: {n_reads} reads x 150 bp ({fq.stat().st_size} bytes), "
        f"{n_windows} valid 31-mer windows, generated in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    ov, oc = oracle_reads_counts(np, codec, fq)
    check(int(oc.sum()) == n_windows, "oracle windows == valid windows")
    want_tsv = render_tsv(np, ov[oc >= 2], oc[oc >= 2], 31)
    want_hist = histogram_bytes(np, oc)
    log(f"oracle: {ov.shape[0]} distinct 31-mers in {time.monotonic() - t0:.1f} s")

    cores = {"os.cpu_count": os.cpu_count(), "sched_getaffinity": len(os.sched_getaffinity(0))}
    os.environ["ORION_KMER_THREADS"] = str(os.cpu_count())  # what the CLI's default -t 0 exports
    default_t = host.parse_threads()
    rates = parse_rates(fq, sorted({1, 2, 4, 8, 16, default_t}))
    log(f"host cores: {cores}; parse threads at the default -t: {default_t} "
        f"(MAX_PARSE_THREADS {host.MAX_PARSE_THREADS}, chunk {host.CHUNK_BYTES} bytes)")
    log(f"parse positions/s by parser threads: {json.dumps(rates)}")

    warm = {}
    results = {}
    for t in (1, os.cpu_count()):
        os.environ["ORION_KMER_THREADS"] = str(t)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        results[t] = engine.count_file(fq, 31, dev)
        torch.cuda.synchronize()
        warm[t] = time.monotonic() - t0
    check(all(np.array_equal(a, b) for a, b in zip(results[1], results[os.cpu_count()])),
          "count_file at -t 1 == at the default")
    check(np.array_equal(results[1][0], ov) and np.array_equal(results[1][1], oc), "count_file == oracle")
    del results
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.count_file(fq, 31, dev)
        torch.cuda.synchronize()
    device_s = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    busy = device_s / warm[os.cpu_count()]
    log(f"warm engine.count_file: -t 1 {warm[1]:.3f} s, default (-t {os.cpu_count()}) "
        f"{warm[os.cpu_count()]:.3f} s; device time {device_s:.3f} s, busy share {100 * busy:.1f} % of the "
        f"default's wall; card: {gpu_name_and_limit()}")

    out, hist = work / "reads.tsv", work / "reads.hist"
    # the card's tail: the fetch and the fused pass counted, the plain
    # path (np.unique's histogram) made to fail
    from orion_kmer_tpu_torch import table
    from orion_kmer_tpu_torch.commands import count as count_cmd
    from orion_kmer_tpu_torch.ingest import native

    calls = {"fetch_table": [], "render_counts": []}
    real = {"fetch_table": table.fetch_table, "render_counts": native.render_counts,
            "write_histogram": count_cmd.write_histogram}

    def counted(name):
        def call(*a):
            calls[name].append(a)
            return real[name](*a)
        return call

    def refused(*a, **kw):
        raise AssertionError("the count's tail took a plain path on the card")

    table.fetch_table, native.render_counts = counted("fetch_table"), counted("render_counts")
    count_cmd.write_histogram = refused
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    t0 = time.monotonic()
    try:
        rc = cli.main(["count", "-k", "31", "-m", "2", "--histogram", str(hist), "-i", str(fq), "-o", str(out)])
        torch.cuda.synchronize()
    finally:
        table.fetch_table, native.render_counts = real["fetch_table"], real["render_counts"]
        count_cmd.write_histogram = real["write_histogram"]
    wall = time.monotonic() - t0
    launches = read_counters()
    check(rc == 0, "count exit code")
    check(len(calls["fetch_table"]) >= 1 and all(a[0].device.type == "cuda" for a in calls["fetch_table"]),
          "the count's table fetched from the card by staging.fetch_table")
    check(len(calls["render_counts"]) == 1 and calls["render_counts"][0][4:6] == (2, True),
          "the count's tail written by one native pass (-m 2, with the histogram)")
    peak = torch.cuda.max_memory_allocated(dev)
    check(out.read_bytes() == want_tsv, "count TSV == oracle bytes")
    check(hist.read_bytes() == want_hist, "count histogram == oracle bytes")
    h = np.loadtxt(hist, dtype=np.int64, ndmin=2)
    check(int((h[:, 0] * h[:, 1]).sum()) == n_windows, "histogram mass == valid windows")
    log(f"count -k 31 -m 2: wall {wall:.3f} s, {n_windows / wall / 1e6:.3f} M k-mers/s, "
        f"{int(h[:, 1].sum())} distinct, {int(h[h[:, 0] >= 2, 1].sum())} with count >= 2, "
        f"peak device memory {peak / 2**30:.3f} GiB; card: {gpu_name_and_limit()}")
    log(f"launches in the main path: {launches}")
    for name in ("K1", "K2", "K3"):
        check(launches[name] > 0, f"{name} launched in the main path")
    check(launches["radix"] == launches["K1"], "the main path's batches sorted by the radix sort, one a batch")
    for caller in ("forest", "fold"):
        check(launches["K2 callers"].get(caller, 0) > 0, f"K2 launched by the {caller} in the main path")

    # -m 1 (every row) and -m above the largest count (no row), at -t 1
    # and at the default: the same histogram; the TSVs against the oracle
    top = int(oc.max()) + 1
    first = {}
    for m, t in ((1, 1), (1, os.cpu_count()), (top, 1), (top, os.cpu_count())):
        o, hh = work / f"m{m}_t{t}.tsv", work / f"m{m}_t{t}.hist"
        check(cli.main(["-t", str(t), "count", "-k", "31", "-m", str(m), "--histogram", str(hh),
                        "-i", str(fq), "-o", str(o)]) == 0, f"count -m {m} -t {t} exit code")
        check(hh.read_bytes() == want_hist, f"count -m {m} -t {t}: histogram == oracle bytes")
        if m == top:
            check(o.stat().st_size == 0, f"count -m {m} -t {t}: no row")
        elif m in first:
            check(o.read_bytes() == first[m].read_bytes(), f"count -m {m} -t {t}: TSV == at -t 1")
        else:
            check(tsv_matches(np, o, ov, oc, 31), f"count -m {m} -t {t}: TSV == oracle bytes")
            first[m] = o
    for o in work.glob("m*_t*.tsv"):
        o.unlink()
    os.environ["ORION_KMER_THREADS"] = str(os.cpu_count())
    log(f"count at -m 1 ({ov.shape[0]} rows) and -m {top} (none), at -t 1 and -t {os.cpu_count()}: "
        "TSVs and histograms == oracle bytes")
    split = tail_split(np, torch, dev, ov, oc, work, (1, os.cpu_count()))
    os.environ["ORION_KMER_THREADS"] = str(os.cpu_count())
    log("tail: " + json.dumps({"card": gpu_name_and_limit(), **split}))

    fresh = {}
    for t in (1, 0):
        o, hh = work / f"cli_t{t}.tsv", work / f"cli_t{t}.hist"
        fresh[t] = cli_subprocess(["-t", t, "count", "-k", 31, "-m", 2, "--histogram", hh, "-i", fq, "-o", o],
                                  work / f"cli_t{t}.log")
        check(o.read_bytes() == want_tsv and hh.read_bytes() == want_hist,
              f"CLI count at -t {t}: TSV and histogram == oracle bytes")
        o.unlink()
    rss = {t: "not measured" if fresh[t][1] is None else f"{fresh[t][1] / 2**30:.3f} GiB" for t in fresh}
    log(f"CLI count in a fresh process: -t 1 {fresh[1][0]:.3f} s, peak RSS {rss[1]}; "
        f"-t 0 {fresh[0][0]:.3f} s, peak RSS {rss[0]} (sampled every 10 ms)")
    log("ingest: " + json.dumps({
        "card": gpu_name_and_limit(), "cores": cores, "default_parse_threads": default_t,
        "parse": rates, "warm_count_file_s": {"t1": warm[1], "default": warm[os.cpu_count()]},
        "cli_fresh_s": {"t1": fresh[1][0], "t0": fresh[0][0]},
        "cli_peak_rss_bytes": {"t1": fresh[1][1], "t0": fresh[0][1]},
        "in_process_cli_s": wall, "device_s": device_s, "busy_share": busy,
    }))

    # the CLI's cold start, stage by stage: rungs 0, 2, 8, 9 and 10 of
    # tools/torch_startup.py's ladder once each, in a fresh process
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_startup

    t0 = time.monotonic()
    rows = torch_startup.ladder([ROOT], fq, work, 1, ["count"], only={"0", "2", "8", "9", "10"})[str(ROOT)]
    log("startup: " + json.dumps({
        "card": gpu_name_and_limit(), "reps": 1, "rungs": torch_startup.medians(rows),
        "stage_costs_s": torch_startup.differences(rows), "ladder_s": time.monotonic() - t0,
    }))
    return launches, fq, out, n_reads, n_windows, genome, read_sample


def kernel_modules():
    from orion_kmer_tpu_torch.ops import compact, extract, merge, radix, sort

    return {"K1": extract, "K2": merge, "K3": compact, "K4": sort, "radix": radix}


def add_modes(dicts) -> dict:
    """K2's launches by caller or K3's by mode, summed over runs."""
    total = {}
    for d in dicts:
        for mode, n in d.items():
            total[mode] = total.get(mode, 0) + n
    return total


def zero_counters():
    """Every kernel's launch count (the radix sort's too), K2's by caller
    and K3's by mode, to 0."""
    kernels = kernel_modules()
    for mod in kernels.values():
        mod.launches = 0
    kernels["K2"].by_caller.clear()
    kernels["K2"].by_size.clear()
    kernels["K3"].by_mode.clear()


def read_counters():
    """Launches of K1-K4 and the radix sort since zero_counters, K2's by
    caller (and by caller and length) and K3's by mode."""
    kernels = kernel_modules()
    out = {name: mod.launches for name, mod in kernels.items()}
    out["K2 callers"] = dict(kernels["K2"].by_caller)
    out["K2 sizes"] = dict(kernels["K2"].by_size)
    out["K3 modes"] = dict(kernels["K3"].by_mode)
    return out


def drive(torch, dev, argv):
    """One command through the port's CLI in this process, with the launch
    counters zeroed just before it: (wall s, launches, peak device bytes)."""
    from orion_kmer_tpu_torch import cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    t0 = time.monotonic()
    rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check(rc == 0, f"{argv[0]} exit code")
    return wall, read_counters(), torch.cuda.max_memory_allocated(dev)


def report(what, wall, launches, peak, extra=""):
    log(f"{what}: wall {wall:.3f} s{extra}, peak device memory {peak / 2**30:.3f} GiB, launches {launches}")


def write_references(np, work: Path, rng, genome) -> dict:
    """Phase 6's three references as FASTA files: the phase-5 genome, a
    copy with 1 % substitutions and an unrelated 5 Mbp genome.  Returns
    {file name: (path, 2-bit codes)}."""
    lut = np.frombuffer(BASES, np.uint8)
    g_b = genome.copy()
    subs = rng.random(g_b.shape[0]) < 0.01
    g_b[subs] = (g_b[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    g_c = rng.integers(0, 4, 5_000_000).astype(np.uint8)
    out = {}
    for name, g in (("genomeA.fa", genome), ("genomeB.fa", g_b), ("genomeC.fa", g_c)):
        write_fasta(work / name, name.encode(), lut[g].tobytes())
        out[name] = (work / name, g)
    return out


def busy_share(torch, run, wall: float):
    """(device seconds, device seconds / wall) of one more ``run()``
    (its result ignored) under torch.profiler, CUDA activity: every kernel
    and copy; ``wall`` is the same work's wall without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_s = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    return device_s, device_s / wall


def query_split(torch, engine, host, fq, db_vals, k: int, dev) -> dict:
    """The host stages of a warm `query -c 10` at the current -t, each
    drained alone, in seconds: the parse (raw bytes); the parse and the
    cut into batches (``host._rebatch_records``); the whole host stage to
    the card (``engine.query_batches``: parse, cut, the pack into the
    pinned ring and the copies); then ``engine.query_file`` under a CPU
    ``torch.profiler``, with the time its consumer waited for a staged
    batch (the port's ``engine.wait`` spans), its two parts (the stream
    of every read's hits, ``engine._query_stream``, and the passing
    reads' ids as lines, ``engine._lines_at``), and its device time
    (torch.profiler).  A checkout without the staged query (a parent's)
    reports the parse, the ``query_file`` wall and the device time; one
    without the spans no wait."""
    try:
        from orion_kmer_tpu_torch.utils import spans
    except ImportError:  # a checkout from before the port's spans
        spans = None
    out = {"parse_threads": host.parse_threads()}
    t0 = time.monotonic()
    out["positions"] = sum(p.codes.shape[0] for p in host.native_chunks(fq, k, normalize=False))
    out["parse_s"] = time.monotonic() - t0
    staged = hasattr(engine, "query_batches")
    if staged:
        batch = host.batch_for(k, dev)
        t0 = time.monotonic()
        chunks = host.native_chunks(fq, k, normalize=False)
        if host.parse_threads() > 1:
            chunks = host._prefetch(chunks, depth=2)
        cut = host._rebatch_records(((p.codes, p.rec_ends, None) for p in chunks), k, batch)
        out["batches"] = sum(1 for _ in cut)
        out["parse_cut_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        for _ in engine.query_batches(fq, k, batch, dev):
            pass
        torch.cuda.synchronize()
        out["stage_s"] = time.monotonic() - t0
    if spans is not None:
        spans.take()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.monotonic()
        engine.query_file(db_vals, fq, k, 10, dev)
        torch.cuda.synchronize()
        out["query_file_s"] = time.monotonic() - t0
    if spans is not None:
        waits = [s.end_ns - s.start_ns for s in spans.take().spans if s.name == "engine.wait"]
        out["consumer_wait_s"] = 1e-9 * sum(waits)
    if staged:
        # query_file's two parts: the stream (every read's hits) and the passing reads' ids
        t0 = time.monotonic()
        blob, id_ends, lens, hits = engine._query_stream(db_vals, fq, k, dev)
        out["stream_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        engine._lines_at(blob, id_ends, (hits >= 10) & (lens >= k))
        out["passing_ids_s"] = time.monotonic() - t0
    out["device_s"], _ = busy_share(torch, lambda: engine.query_file(db_vals, fq, k, 10, dev), 1.0)
    return out


def phase_joins(np, torch, codec, work: Path, rng, dev, fq, count_tsv, n_reads, n_windows, genome, sample):
    """The realistic joins, each command in process with the launch
    counters zeroed just before it.  Returns the launches of each run, the
    references' oracle k-mer sets, the DB built from them and the count
    table of phase 5 (k-mers with count >= 2)."""
    from orion_kmer_tpu_torch import cli, engine, host
    from orion_kmer_tpu_torch.db import KmerDb
    from orion_kmer_tpu_torch.keys import keys_from_u64, u64_from_keys

    k = 31
    kernels = kernel_modules()
    sort = kernels["K4"]

    refs, paths = {}, []
    for name, (path, g) in write_references(np, work, rng, genome).items():
        paths.append(path)
        refs[name] = sorted_unique(np, codec.extract_kmers_np(g, k))
    union = sorted_unique(np, np.concatenate(list(refs.values())))
    runs = {}

    db = work / "refs.db"
    wall, launches, peak = drive(torch, dev, ["build", "-k", k, "-g", *paths, "-o", db])
    got = KmerDb.load(db).references
    check(sorted(got) == sorted(refs) and all(np.array_equal(got[n], refs[n]) for n in refs), "build -k 31 == oracle")
    report(f"build -k 31 of 3 references ({union.shape[0]} unique 31-mers)", wall, launches, peak)
    runs["build"] = launches

    ids = work / "ids.txt"
    query_argv = ["query", "-d", db, "-r", fq, "-o", ids, "-c", 10]
    wall, launches, peak = drive(torch, dev, query_argv)
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
    warm = {}
    for t in (1, 0):
        out = work / f"ids_t{t}.txt"
        torch.cuda.synchronize()
        t0 = time.monotonic()
        check(cli.main(["-t", str(t), *map(str, query_argv[:-4]), "-o", str(out), "-c", "10"]) == 0, "query exit code")
        torch.cuda.synchronize()
        warm[t] = time.monotonic() - t0
        check(out.read_bytes() == ids.read_bytes(), f"query -c 10 at -t {t} == the counted run's bytes")
    device_s, busy = busy_share(torch, lambda: cli.main([str(a) for a in query_argv]), warm[0])
    log(f"query -c 10 warm: -t 1 {warm[1]:.3f} s, default {warm[0]:.3f} s (bytes equal); device time "
        f"{device_s:.3f} s, busy share {100 * busy:.1f} % of the default's wall; card: {gpu_name_and_limit()}")
    log("query host stages: " + json.dumps(query_split(torch, engine, host, fq, union, k, dev)))

    out, tsv = work / "cl.json", work / "cl.tsv"
    wall, launches, peak = drive(torch, dev, ["classify", "-i", fq, "-d", db, "-o", out, "--min-kmer-frequency", 2, "--output-tsv", tsv])
    vals_tsv, counts_tsv = parse_tsv(np, codec, count_tsv.read_bytes(), k)
    check_classify(np, out, tsv, fq, db, refs, vals_tsv, counts_tsv)
    report(f"classify -m 2 ({vals_tsv.shape[0]} input k-mers, exact)", wall, launches, peak)
    runs["classify"] = launches
    classify_argv = ["classify", "-i", fq, "-d", db, "-o", out, "--min-kmer-frequency", 2, "--output-tsv", tsv]
    device_s, busy = busy_share(torch, lambda: cli.main([str(a) for a in classify_argv]), wall)
    log(f"classify -m 2: device time {device_s:.3f} s, busy share {100 * busy:.1f} % of its wall; "
        f"card: {gpu_name_and_limit()}")

    db2, cmp_out = work / "ab.db", work / "cmp.json"
    check(cli.main(["build", "-k", str(k), "-g", str(paths[0]), str(paths[1]), "-o", str(db2)]) == 0, "build A B")
    wall, launches, peak = drive(torch, dev, ["compare", "--db1", db, "--db2", db2, "-o", cmp_out])
    u2 = sorted_unique(np, np.concatenate([refs["genomeA.fa"], refs["genomeB.fa"]]))
    inter = int(np.intersect1d(union, u2).shape[0])
    got = json.loads(cmp_out.read_text())
    check(got["intersection_size"] == inter and got["union_size"] == union.shape[0] + u2.shape[0] - inter,
          "compare == np.intersect1d")
    report(f"compare ({inter} shared 31-mers, exact)", wall, launches, peak)
    runs["compare"] = launches

    for what in ("query", "classify", "compare"):
        check(runs[what]["K2 callers"].get("join", 0) > 0, f"K2 launched by the join in {what}")
    check(runs["query"]["K1"] > 0, "K1 launched in query")

    # K4's own path: no command reaches it, so drive its entry, sort_pairs,
    # on canonical 31-mers of the reads
    zero_counters()
    vals = np.concatenate([codec.extract_kmers_np(codec.seq_to_codes(sample[i]), k) for i in picked[:200]])
    for m in (1 << 14, 12289):
        got = u64_from_keys(sort.sort_pairs(keys_from_u64(vals[:m]).to(dev)))
        check(np.array_equal(got, np.sort(vals[:m])), f"sort_pairs of {m} keys == np.sort")
    runs["sort_pairs"] = read_counters()
    log(f"sort_pairs entry: launches {runs['sort_pairs']}")
    check(runs["sort_pairs"]["K4"] == 2, "K4 launched by its entry")
    return runs, refs, db, (vals_tsv, counts_tsv)


def write_clades(np, work: Path, rng, n_genomes: int = 50, n_clades: int = 5, length: int = 5_000_000):
    """n_genomes synthetic bacterial genomes in n_clades clades: each one
    its clade's random ancestor with 0.1-5 % substitutions, so that the
    Jaccard of two genomes runs from ~0 (two clades) to ~0.9 (two close
    relatives).  Returns the paths and the genomes' 2-bit codes."""
    lut = np.frombuffer(BASES, np.uint8)
    rates = np.geomspace(0.001, 0.05, n_genomes // n_clades)
    paths, genomes = [], []
    for c in range(n_clades):
        ancestor = rng.integers(0, 4, length).astype(np.uint8)
        for j, rate in enumerate(rates):
            g = ancestor.copy()
            subs = rng.random(length) < rate
            g[subs] = (g[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
            path = work / f"clade{c}_g{j}.fa"
            write_fasta(path, path.stem.encode(), lut[g].tobytes())
            paths.append(path)
            genomes.append(g)
    return paths, genomes


def sketch_oracle(np, codec, hash_np, codes, k: int, scaled: int):
    """(sorted kept hashes, abundances) of one sequence's canonical k-mer
    windows, by numpy: splitmix64 of every window, the threshold, then the
    unique survivors and their multiplicities."""
    h = hash_np(codec.extract_kmers_np(codes, k))
    kept = np.sort(h[h < np.uint64((1 << 64) // scaled)])
    if kept.shape[0] == 0:
        return kept, np.empty(0, np.int64)
    head = np.concatenate([[True], kept[1:] != kept[:-1]])
    starts = np.flatnonzero(head)
    return kept[starts], np.diff(np.concatenate([starts, [kept.shape[0]]]))


def sig_hashes(sketch):
    return [int(h) for h in sketch["hashes"]]


def phase_sketch(np, torch, codec, work: Path, rng, dev, fq, read_bases, table_ge2):
    """BASELINE config #3: `sketch -k 31 --scaled 1000` of 50 genomes and of
    the phase-5 reads, and `sketch-compare` of the 50 (1,225 pairs), in
    process with the counters zeroed before each.  Every genome's sketch
    (hashes and abundances) against the numpy oracle; every pair's
    intersection against ``pairwise_intersections`` of the oracle sketches,
    itself held to np.intersect1d; the reads' sketch entries of abundance
    >= 2 against the phase-5 count table.  Returns the launches of each
    run and the reads' sketch."""
    from concurrent.futures import ThreadPoolExecutor

    from orion_kmer_tpu_torch.ops.hash import splitmix64_np
    from orion_kmer_tpu_torch.ops.sketch import pairwise_intersections

    k, scaled = 31, 1000
    t0 = time.monotonic()
    paths, genomes = write_clades(np, work, rng)
    n_bases = sum(g.shape[0] for g in genomes)
    log(f"sketch run: {len(paths)} genomes, {n_bases} bases, generated in {time.monotonic() - t0:.1f} s")
    runs = {}

    sig = work / "genomes.sig"
    wall, launches, peak = drive(torch, dev, ["sketch", "-k", k, "--scaled", scaled, "-i", *paths, "-o", sig])
    report(f"sketch -k {k} --scaled {scaled} of {len(paths)} genomes", wall, launches, peak,
           f", {n_bases / wall / 1e9:.4f} Gbp/s")
    check(launches["K1"] > 0 and launches["K3"] > 0, "K1 and K3 launched in sketch")
    runs["sketch genomes"] = launches
    doc = json.loads(sig.read_text())
    check([s["name"] for s in doc["sketches"]] == [str(p) for p in paths], "one sketch per genome, in order")
    t0 = time.monotonic()
    with ThreadPoolExecutor(8) as pool:
        oracle = list(pool.map(lambda g: sketch_oracle(np, codec, splitmix64_np, g, k, scaled), genomes))
    for s, (h, a) in zip(doc["sketches"], oracle):
        check(sig_hashes(s) == h.tolist() and s["abundances"] == a.tolist(), f"sketch of {s['name']} == oracle")
    sizes = [h.shape[0] for h, _ in oracle]
    log(f"every genome sketch == oracle (hashes and abundances, {min(sizes)}-{max(sizes)} hashes each; "
        f"oracle {time.monotonic() - t0:.1f} s)")

    cmp_out = work / "genomes_cmp.json"
    wall, launches, peak = drive(torch, dev, ["sketch-compare", "-s", sig, "-o", cmp_out])
    runs["sketch-compare"] = launches
    mat = pairwise_intersections([h for h, _ in oracle])
    pairs = json.loads(cmp_out.read_text())["pairs"]
    n = len(paths)
    check(len(pairs) == n * (n - 1) // 2, "sketch-compare: every pair")
    it = iter(pairs)
    for i in range(n):
        for j in range(i + 1, n):
            p = next(it)
            inter = int(mat[i, j])
            check(inter == np.intersect1d(oracle[i][0], oracle[j][0], assume_unique=True).shape[0],
                  "pairwise_intersections == np.intersect1d")
            union = sizes[i] + sizes[j] - inter
            check(p["intersection"] == inter and p["union"] == union and p["jaccard"] == inter / union,
                  f"sketch-compare pair {i} {j} == oracle")
    jac = [p["jaccard"] for p in pairs]
    report(f"sketch-compare of {n} sketches ({len(pairs)} pairs exact, Jaccard {min(jac):.4f}-{max(jac):.4f})",
           wall, launches, peak)

    reads_sig = work / "reads.sig"
    wall, launches, peak = drive(torch, dev, ["sketch", "-k", k, "--scaled", scaled, "-i", fq, "-o", reads_sig])
    runs["sketch reads"] = launches
    reads_sketch = json.loads(reads_sig.read_text())["sketches"][0]
    got = dict(zip(sig_hashes(reads_sketch), reads_sketch["abundances"]))
    vals, counts = table_ge2
    h = splitmix64_np(vals)
    keep = h < np.uint64((1 << 64) // scaled)
    want = dict(zip(h[keep].tolist(), counts[keep].tolist()))
    check({x: a for x, a in got.items() if a >= 2} == want, "reads sketch, abundance >= 2 == the count table")
    check(sig_hashes(reads_sketch) == sorted(got), "reads sketch ascending")
    report(f"sketch -k {k} --scaled {scaled} of the reads ({len(got)} hashes, {len(want)} with abundance >= 2 exact)",
           wall, launches, peak, f", {read_bases / wall / 1e9:.4f} Gbp/s")
    return runs, reads_sketch


def write_small_sample(np, path: Path, rng, genome, n_reads: int = 20_000, read_len: int = 150):
    """A second, smaller sample: reads of the genome with 0.5 % errors and
    a few N runs.  Returns their sequences."""
    lut = np.frombuffer(BASES + b"N", np.uint8)
    starts = rng.integers(0, genome.shape[0] - read_len, n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)]
    err = rng.random(reads.shape) < 0.005
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()))) % 4
    reads[rng.random(n_reads) < 0.01, 70:75] = 4
    seqs = [lut[r].tobytes() for r in reads]
    with open(path, "wb") as f:
        f.write(b"".join(b"@s%d\n%s\n+\n%s\n" % (i, s, b"I" * read_len) for i, s in enumerate(seqs)))
    return seqs


def phase_profile(np, torch, codec, work: Path, rng, dev, fq, n_windows, genome, refs, db, reads_sketch):
    """BASELINE config #4 on one card: `profile -k 31 -d DB --scaled 1000`
    of the phase-5 reads, a smaller sample and a sample whose file is
    missing.  The small sample exactly against the numpy oracle (totals,
    unique, max multiplicity, the sketch, every reference's matches and
    depth); the reads: totals against the generator's window count, the
    sketch against the `sketch` command's, unique, max and the references
    against ``engine.count_file`` (held to phase 5's table) with the
    oracle's reference sets."""
    from orion_kmer_tpu_torch import engine
    from orion_kmer_tpu_torch.ops.hash import splitmix64_np

    k, scaled = 31, 1000
    small = work / "small_sample.fastq"
    seqs = write_small_sample(np, small, rng, genome)
    manifest = work / "manifest.json"
    manifest.write_text(json.dumps([
        {"sample": "reads", "files": [str(fq)]},
        {"sample": "small", "files": [str(small)]},
        {"sample": "missing", "files": [str(work / "missing.fastq")]},
    ]))
    out = work / "profile.json"
    wall, launches, peak = drive(torch, dev, ["profile", "-k", k, "--manifest", manifest, "-d", db,
                                              "--scaled", scaled, "-o", out])
    doc = json.loads(out.read_text())
    big, sm, missing = doc["profiles"]
    check(doc["n_ok"] == 2 and doc["n_error"] == 1, "profile: two samples ok, one error")
    check(missing["status"] == "error" and "missing.fastq" in missing["error"], "profile: the missing sample's error")

    vals, counts = oracle_counts(np, codec, seqs, k)
    check(sm["total_kmers"] == int(counts.sum()) and sm["unique_kmers"] == vals.shape[0]
          and sm["max_multiplicity"] == int(counts.max()), "profile small sample: totals == oracle")
    h = splitmix64_np(vals)
    h = np.sort(h[h < np.uint64((1 << 64) // scaled)])
    check(sig_hashes(sm["sketch"]) == h.tolist(), "profile small sample: sketch == oracle")
    check_db_result(np, sm["databases_analyzed"][0], refs, vals, counts, "profile small sample")

    check(big["total_kmers"] == n_windows, "profile reads: total == valid windows")
    check(sig_hashes(big["sketch"]) == sig_hashes(reads_sketch), "profile reads: sketch == the sketch command's")
    rvals, rcounts = engine.count_file(fq, k, dev)
    check(big["unique_kmers"] == rvals.shape[0] and big["max_multiplicity"] == int(rcounts.max()),
          "profile reads: unique and max == count_file")
    check_db_result(np, big["databases_analyzed"][0], refs, rvals, rcounts, "profile reads")
    report(f"profile -k {k} --scaled {scaled} -d (3 samples, 1 missing; {big['unique_kmers']} + "
           f"{sm['unique_kmers']} distinct k-mers, exact)", wall, launches, peak,
           f", {doc['samples_per_hour']} samples/h")
    return {"profile": launches}


def phase_serve(torch, work: Path, dev, count_input, sketch_inputs):
    """`serve --warm-k 31` as a subprocess: a `count` and a `sketch`
    forwarded twice each, byte-equal to direct runs in this process (whose
    launches are returned); the walls of the first and second request;
    shutdown removes the socket and ends the server."""
    from orion_kmer_tpu_torch.server import forward

    sock = work / "okt.sock"
    err_log = work / "serve.err"
    t0 = time.monotonic()
    with open(err_log, "wb") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "orion_kmer_tpu_torch", "serve", "--socket", str(sock), "--warm-k", "31"],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err_f,
        )
    try:
        while not sock.exists():
            check(proc.poll() is None, f"serve exited early: {err_log.read_text()[-2000:]}")
            check(time.monotonic() - t0 < 600, "serve ready within 600 s")
            time.sleep(0.05)
        log(f"serve --warm-k 31: socket ready {time.monotonic() - t0:.3f} s after the process started")
        requests = {
            "count": lambda o: ["count", "-k", 31, "-i", count_input, "-o", o],
            "sketch": lambda o: ["sketch", "-k", 31, "--scaled", 1000, "-i", *sketch_inputs, "-o", o],
        }
        runs = {}
        for name, argv_of in requests.items():
            direct = work / f"direct_{name}.out"
            wall, launches, _ = drive(torch, dev, argv_of(direct))
            runs[f"serve direct {name}"] = launches
            walls = []
            for i in range(2):
                served = work / f"served_{name}{i}.out"
                t1 = time.monotonic()
                rc = forward(sock, [str(a) for a in argv_of(served)])
                walls.append(time.monotonic() - t1)
                check(rc == 0, f"served {name} exit code")
                check(served.read_bytes() == direct.read_bytes(), f"served {name} == direct run")
            log(f"served {name}: first request {walls[0]:.3f} s, second {walls[1]:.3f} s, "
                f"direct in this process {wall:.3f} s; bytes equal")
        check(forward(sock, ["shutdown"]) == 0, "shutdown exit code")
        check(proc.wait(60) == 0, "serve exit code")
        check(not sock.exists(), "shutdown removes the socket")
        log("serve: shut down, socket removed")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return runs


def drive_sharded(torch, n_shards: int, argv):
    """`drive` with ORION_KMER_SHARDS set: (wall s, launches, peak device
    bytes summed over the cards, the run's stats_report as logged by
    ``engine.count_file``)."""
    import ast
    import logging

    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    engine_log = logging.getLogger("orion_kmer_tpu_torch.engine")
    level, propagate, before = engine_log.level, engine_log.propagate, os.environ.get("ORION_KMER_SHARDS")
    engine_log.addHandler(handler)
    engine_log.setLevel(logging.INFO)
    engine_log.propagate = False
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for card in cards:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
    os.environ["ORION_KMER_SHARDS"] = str(n_shards)
    try:
        wall, launches, _ = drive(torch, cards[0], argv)
    finally:
        if before is None:
            del os.environ["ORION_KMER_SHARDS"]
        else:
            os.environ["ORION_KMER_SHARDS"] = before
        engine_log.removeHandler(handler)
        engine_log.setLevel(level)
        engine_log.propagate = propagate
    for card in cards:
        torch.cuda.synchronize(card)
    peak = sum(torch.cuda.max_memory_allocated(card) for card in cards)
    reports = [m for m in seen if m.startswith("sharded count: ")]
    check(len(reports) == 1, "the run went through the sharded table once")
    stats = ast.literal_eval(reports[0][len("sharded count: "):])
    check(stats["n_shards"] == n_shards and stats["route_retries"] == 0, "the sharded table's shard count")
    check(stats["a2a_bytes_sent"] == 8 * stats["recv_sort_elements"], "8 bytes routed for every key received")
    check((stats["a2a_bytes_ici"] > 0) == (len(set(stats["devices"])) > 1),
          "bytes change device exactly when the shards sit on several")
    return wall, launches, peak, stats


def phase_sharded(np, torch, codec, work: Path, fq, count_tsv, n_windows, big_fasta, oracle_tsv21):
    """Phase 10: the sharded count through the CLI and the library entries.
    Returns the launches of each run."""
    from orion_kmer_tpu_torch.parallel import ShardedCountTable, make_mesh, sharded_count

    n_cards = torch.cuda.device_count()
    mesh = make_mesh(4)
    log(f"sharded count: 4 shards on {[str(d) for d in mesh]} "
        f"({'one card each' if n_cards >= 4 else f'sharing {n_cards} card(s)'})")
    # reckoned peak on one card, S = 4, 2^24-position batches, flush at 2^28
    # positions: the four forests hold the flush window's keys between them
    # (2^28 x 8 B = 2 GiB); one shard at a time encodes its quarter (keys,
    # positions, shifted keys and two compaction outputs of 2^26 x 8 B, 2.5
    # GiB with the masks); the tables hold the distinct k-mers (16 B each);
    # a batch's exchange holds 2^24 keys three times (K1's, the routed
    # buffers, the received) for 0.4 GiB
    log("sharded count, reckoned peak with the shards on one card: 2 GiB of forests + 2.5 GiB for one "
        "shard's flush + tables + 0.4 GiB of exchange buffers, about 5 to 6 GiB; the single table peaks at 10.6")
    runs = {}
    out, hist = work / "reads_s4.tsv", work / "reads_s4.hist"
    wall, launches, peak, stats = drive_sharded(torch, 4, [
        "count", "-k", 31, "-m", 2, "--histogram", hist, "-i", fq, "-o", out])
    check(out.read_bytes() == count_tsv.read_bytes(), "sharded count TSV == phase 5's bytes")
    check(hist.read_bytes() == count_tsv.with_suffix(".hist").read_bytes(), "sharded count histogram == phase 5's bytes")
    report("count -k 31 -m 2 --histogram, ORION_KMER_SHARDS=4 (TSV and histogram equal to phase 5's)",
           wall, launches, peak, f", {n_windows / wall / 1e6:.3f} M k-mers/s")
    log(f"stats_report: {stats}")
    check(stats["positions"] > n_windows, "every position of the reads went through the sharded table")
    for name in ("K1", "K2", "K3"):
        check(launches[name] > 0, f"{name} launched in the sharded count")
    check(launches["K3 modes"].get("route") == launches["K1"], "the route: one K3 launch per block (K1 launch)")
    runs["count, 4 shards"] = launches

    out = work / "big_s3.tsv"
    wall, launches, peak, stats = drive_sharded(torch, 3, ["count", "-k", 21, "-i", big_fasta, "-o", out])
    check(out.read_bytes() == oracle_tsv21, "count k=21, 3 shards, TSV == oracle")
    report("count -k 21 of the 9 Mbp FASTA, ORION_KMER_SHARDS=3 (byte-exact)", wall, launches, peak)
    log(f"stats_report: {stats}")
    check(launches["K3 modes"].get("route") == launches["K1"], "the route: one K3 launch per block (K1 launch)")
    runs["count, 3 shards"] = launches

    zero_counters()
    codes = codec.seq_to_codes(b"T" * 40)
    for n_shards in (3, 4):
        vals, counts = sharded_count(codes, codes > 3, 32, make_mesh(n_shards))
        check(vals.tolist() == [0] and counts.tolist() == [9], f"sharded_count, T*40 at k=32, {n_shards} shards")
        table = ShardedCountTable(32, make_mesh(n_shards))
        table.update(codes)
        table.flush()
        table.update(codes)
        vals, counts = table.result()
        check(vals.tolist() == [0] and counts.tolist() == [18], f"ShardedCountTable, T*40 twice at k=32, {n_shards} shards")
    runs["sharded T*40 edge"] = read_counters()
    log(f"sharded_count and ShardedCountTable on the T*40 k = 32 edge: exact; launches {runs['sharded T*40 edge']}")
    return runs


NCCL_ONE_RANK = """
import json, sys
import numpy as np
import torch, torch.distributed as dist
from orion_kmer_tpu_torch import codec
from orion_kmer_tpu_torch.ops import compact, extract, radix
from orion_kmer_tpu_torch.parallel.distributed import multihost_sharded_count

dist.init_process_group("nccl", init_method="tcp://localhost:" + sys.argv[1], world_size=1, rank=0)
rng = np.random.default_rng(5)
codes = rng.integers(0, 4, size=1 << 20, dtype=np.uint8)
codes[rng.random(codes.shape[0]) < 0.001] = 255
stats = {}
vals, counts = multihost_sharded_count(codes, codes > 3, 31, "cuda", stats=stats)
exp_v, exp_c = np.unique(codec.extract_kmers_np(codes, 31), return_counts=True)
assert np.array_equal(vals, exp_v) and np.array_equal(counts, exp_c)
torch.cuda.synchronize()
dist.destroy_process_group()
print(json.dumps({"unique": int(vals.shape[0]), "K1": extract.launches, "K3": compact.launches,
                  "K3 modes": compact.by_mode, "radix": radix.launches, "stats": stats}))
"""

# two ranks of two shards each count the 9 Mbp FASTA at k = 21: a warm-up
# count of the T*40 edge, then the timed one with the launch counters zeroed
# just before it; rank 0 saves the result for the oracle
BIG_RANKS = """
import json, sys, time
import numpy as np
import torch, torch.distributed as dist
from orion_kmer_tpu_torch import codec
from orion_kmer_tpu_torch.ingest.fastx import parse_fastx_file
from orion_kmer_tpu_torch.ops import compact, extract, radix
from orion_kmer_tpu_torch.parallel.distributed import maybe_initialize_distributed, multihost_sharded_count, rank_devices
from orion_kmer_tpu_torch.parallel.mesh import make_mesh

fasta, out = sys.argv[1:]
assert maybe_initialize_distributed("cuda")
mesh = make_mesh(2, rank_devices("cuda"))
sep = np.full(1, 255, np.uint8)
codes = np.concatenate([x for r in parse_fastx_file(fasta) for x in (codec.seq_to_codes(r.seq), sep)])
edge = codec.seq_to_codes(b"T" * 40)
multihost_sharded_count(edge, edge > 3, 21, "cuda", devices=mesh)
for card in set(mesh):
    torch.cuda.synchronize(card)
extract.launches = compact.launches = radix.launches = 0
compact.by_mode.clear()
dist.barrier()
t0 = time.perf_counter()
stats = {}
vals, counts = multihost_sharded_count(codes, codes > 3, 21, "cuda", stats=stats, devices=mesh)
wall = time.perf_counter() - t0
if dist.get_rank() == 0:
    np.save(out + ".vals.npy", vals)
    np.save(out + ".counts.npy", counts)
print(json.dumps({"rank": dist.get_rank(), "devices": [str(d) for d in mesh], "wall_s": round(wall, 3),
                  "K1": extract.launches, "K3": compact.launches, "K3 modes": compact.by_mode,
                  "radix": radix.launches, "stats": stats}))
dist.destroy_process_group()
"""


def phase_two_processes(np, torch, work: Path, big_fasta, oracle_tsv21):
    """Phase 11: ranks on the card(s) through the environment contract,
    each count against the numpy oracle: two ranks of one shard, two ranks
    of two shards (nccl with two cards a rank on a four-card host, gloo
    with all four shards on the card otherwise), one rank over nccl, and
    two ranks of two shards on the 9 Mbp FASTA at k = 21.  Returns the
    launches of the ranks, summed."""
    import socket

    from orion_kmer_tpu_torch.parallel.distributed import (
        choose_backend, local_devices, run_ranks, run_two_process_smoke,
    )

    n_cards = torch.cuda.device_count()
    runs = {}
    for shards in (1, 2):
        t0 = time.monotonic()
        res = run_two_process_smoke(work / f"two_processes_{shards}", timeout=300.0, device="cuda", shards=shards)
        for c in res["counts"]:
            st = c["stats"]
            check(st["backend"] == choose_backend("cuda", 2) and st["n_shards"] == 2 * shards and st["n_processes"] == 2,
                  f"two ranks of {shards} shard(s), {c['count']}: backend, shards and processes")
        share = [[f"cuda:{i}" for i in local_devices(["host"] * 2, r, n_cards)] for r in range(2)]
        check(res["devices"] == [[d[s % len(d)] for s in range(shards)] for d in share],
              "each rank's shards sit on its share of the cards")
        log(f"two ranks x {shards} shard(s) on {n_cards} card(s) over {res['a2a_stats']['backend']}, shards on "
            f"{res['devices']}: k = 9, 21, 32 and T*40 == oracle on both ranks, {time.monotonic() - t0:.1f} s with "
            f"process start; unique {[c['unique'] for c in res['counts']]}; k = 9 stats {res['a2a_stats']}; "
            f"launches {res['launches']}")
        runs[f"two ranks x {shards} shard(s)"] = {
            "K1": sum(r["K1"] for r in res["launches"]), "K2": 0, "K3": sum(r["K3"] for r in res["launches"]),
            "K3 modes": add_modes(r["K3 modes"] for r in res["launches"]),
            "radix": sum(r["radix"] for r in res["launches"])}

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", NCCL_ONE_RANK, str(port)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"one rank over nccl: {proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    st = got["stats"]
    check(st["backend"] == "nccl" and st["n_shards"] == n_cards and got["K1"] == n_cards and got["K3"] > 0,
          "the lone nccl rank took every card and launched K1 and K3 on each")
    log(f"one rank over nccl, one shard on each of {n_cards} card(s), 2^20 positions at k = 31: == oracle, "
        f"{got['unique']} unique, {time.monotonic() - t0:.1f} s with process start; {got}")
    runs["one nccl rank"] = {"K1": got["K1"], "K2": 0, "K3": got["K3"], "K3 modes": got["K3 modes"],
                             "radix": got["radix"]}

    t0 = time.monotonic()
    out = work / "big_ranks"
    outs = run_ranks(BIG_RANKS, [[big_fasta, out]] * 2, work / "big_ranks_work", timeout=300.0)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    vals, counts = np.load(f"{out}.vals.npy"), np.load(f"{out}.counts.npy")
    check(render_tsv(np, vals, counts, 21) == oracle_tsv21, "two ranks x 2 shards, 9 Mbp at k = 21 == oracle")
    for r in ranks:
        st = r["stats"]
        check(st["n_shards"] == 4 and st["n_processes"] == 2 and r["K1"] == 2 and r["K3"] == 2 + 2
              and r["K3 modes"] == {"route": 2, "positions": 2},
              "each rank extracted its two blocks, routed each four ways in one K3 pass and encoded its two owners")
        log(f"two ranks x 2 shards, count of the 9 Mbp FASTA at k = 21, rank {r['rank']} on {r['devices']}: "
            f"== oracle, wall {r['wall_s']:.3f} s (warm, first call excluded), launches K1 {r['K1']} K3 {r['K3']}, "
            f"stats {st}")
    log(f"two ranks x 2 shards on the 9 Mbp FASTA: {time.monotonic() - t0:.1f} s with process start")
    runs["two ranks x 2 shards, 9 Mbp"] = {"K1": sum(r["K1"] for r in ranks), "K2": 0, "K3": sum(r["K3"] for r in ranks),
                                           "K3 modes": add_modes(r["K3 modes"] for r in ranks),
                                           "radix": sum(r["radix"] for r in ranks)}
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gbp", type=float, default=0.5, help="Gbp of reads in the realistic run")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and kernels), printing no result line")
    ap.add_argument("--sharded-only", action="store_true",
                    help="after phase 3 run only the phase-5 count and phases 10-11 (the sharded count and "
                         "the two-process run), printing no result line: the quick check on a machine with several cards")
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
    passed("phase 3 kernels (exact)")
    if args.kernels_only:
        log(f"{card}; stopped after phase 3 (--kernels-only): no result line")
        return 0

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        if args.sharded_only:
            records = write_multirecord_fasta(np, work / "big.fasta", rng, 9_000_000)
            oracle_tsv21 = render_tsv(np, *oracle_counts(np, codec, records, 21), 21)
        else:
            oracle_tsv21 = phase_exact(np, codec, work, rng)
            passed("phase 4 exact run")
        launches, fq, count_tsv, n_reads, n_windows, genome, sample = phase_realistic(
            np, torch, codec, work, rng, args.gbp, dev
        )
        passed("phase 5 realistic run")
        runs = {}
        if not args.sharded_only:
            runs, refs, db, table_ge2 = phase_joins(
                np, torch, codec, work, rng, dev, fq, count_tsv, n_reads, n_windows, genome, sample
            )
            passed("phase 6 realistic joins")
            sketch_runs, reads_sketch = phase_sketch(np, torch, codec, work, rng, dev, fq, 150 * n_reads, table_ge2)
            runs.update(sketch_runs)
            passed("phase 7 sketch")
            runs.update(phase_profile(np, torch, codec, work, rng, dev, fq, n_windows, genome, refs, db, reads_sketch))
            passed("phase 8 profile")
            runs.update(phase_serve(torch, work, dev, work / "big.fasta", sorted(work.glob("clade0_g*.fa"))[:2]))
            passed("phase 9 serve")
        runs.update(phase_sharded(np, torch, codec, work, fq, count_tsv, n_windows, work / "big.fasta", oracle_tsv21))
        passed("phase 10 sharded count")
        runs.update(phase_two_processes(np, torch, work, work / "big.fasta", oracle_tsv21))
        passed("phase 11 two processes")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    if args.sharded_only:
        log(f"{card}; ran phases 1-3, 5, 10 and 11 (--sharded-only): no result line")
        return 0

    # launches: K1-K3 and the radix sort summed over the in-process runs of
    # phases 5 to 10 and the ranks of phase 11; K4, which no command
    # reaches, from its entry's run
    runs["count"] = launches
    for name, r in runs.items():
        log(f"launches of {name}: {r}")
    total = {key: sum(r[key] for name, r in runs.items() if name != "sort_pairs") for key in ("K1", "K2", "K3", "radix")}
    total["K4"] = runs["sort_pairs"]["K4"]
    log(f"K2 launches by caller, summed as K2 is: {add_modes(r.get('K2 callers', {}) for name, r in runs.items())}")
    log(f"K2 launches by caller and length: {add_modes(r.get('K2 sizes', {}) for name, r in runs.items())}")
    log(f"K3 launches by mode, summed as K3 is: {add_modes(r.get('K3 modes', {}) for name, r in runs.items())}")
    pkg = "orion_kmer_tpu_torch/csrc"
    kernels = [
        ("K1 extract", f"{pkg}/extract.cu", "orion_kmer_tpu/ops/kmers_pallas.py:29"),
        ("K2 merge", f"{pkg}/merge.cu", "orion_kmer_tpu/ops/sort_pallas.py:222"),
        ("K3 compact", f"{pkg}/compact.cu", "orion_kmer_tpu/ops/sort_pallas.py:463"),
        ("K4 sort", f"{pkg}/sort.cu", "orion_kmer_tpu/ops/sort_pallas.py:153"),
        ("radix sort", f"{pkg}/radix.cu", "no Pallas kernel: torch.sort(keys).values (orion_kmer_tpu/ops/count.py: lax.sort)"),
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
