#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orion_kmer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--gbp G]

Phases, in order; any failure raises and exits non-zero:
  1. device: the card's name and power limit, native ingest status;
  2. build: compile the CUDA kernels of orion_kmer_tpu_torch/csrc;
  3. kernels: K1 (extract), K2 (merge) and K3 (compact) against their
     plain torch versions on the card, at the main path's shapes, exactly,
     with median times from CUDA events;
  4. exact run: `count` at k = 15, 21, 31, 32 (once with small batches
     and a lowered device-table bound, so the forest deepens and the table
     spills), `build -k 21` and the T*40 k = 32 edge, all through the CLI
     in subprocesses, byte for byte against the numpy oracle of
     orion_kmer_tpu.codec;
  5. realistic run: `count -k 31 -m 2 --histogram` over a synthetic
     E. coli-like FASTQ (a 4.64 Mbp genome, 150 bp reads, 0.2 %
     substitutions, a few N runs; --gbp of sequence), in process, with the
     kernel launch counters reset just before it; checks the histogram
     mass against the valid windows, ascending output keys and canonical
     output k-mers.
The last line is the result JSON; the kernel JSON and the card's
`nvidia-smi` name and power limit are printed before it.  Needs no
network and no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BASES = b"ACGT"


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


def median_ms(torch, fn, reps: int = 10) -> float:
    """Median time of fn() on the current stream, by CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def parse_tsv_keys(np, codec, data: bytes, k: int):
    """u64 k-mers of a count TSV, vectorized."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size == 0:
        return np.empty(0, np.uint64)
    ends = np.flatnonzero(raw == ord("\n"))
    starts = np.concatenate([[0], ends[:-1] + 1])
    check(bool((raw[starts + k] == ord("\t")).all()), "TSV k-mer column width")
    codes = codec.seq_to_codes(raw[starts[:, None] + np.arange(k)].reshape(-1)).reshape(-1, k)
    check(bool((codes < 4).all()), "TSV k-mers are ACGT")
    vals = np.zeros(starts.shape[0], np.uint64)
    for j in range(k):
        vals = (vals << np.uint64(2)) | codes[:, j].astype(np.uint64)
    return vals


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


def write_reads_fastq(np, path: Path, rng, gbp: float, read_len: int = 150):
    """Synthetic E. coli-like FASTQ: reads from both strands of one
    4.64 Mbp random genome, 0.2 % substitutions, N runs in 1 read in 5000.
    Returns (n_reads, valid 31-mer windows over all reads)."""
    k = 31
    genome = rng.integers(0, 4, 4_641_652).astype(np.uint8)
    n_reads = int(gbp * 1e9) // read_len
    lut = np.frombuffer(BASES + b"N", np.uint8)
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
    return n_reads, valid


# ---------------------------------------------------------------- phases


def phase_kernels(np, torch, codec, dev, rng):
    """Each kernel against its plain version on the card; returns the
    kernel records (times, errors) for the JSON line."""
    from orion_kmer_tpu_torch.host import pack_for_transfer
    from orion_kmer_tpu_torch.ops import compact, extract, merge

    rec = {}

    # K1: a 2^24-position batch with N runs
    n = 1 << 24
    codes = np.frombuffer(BASES, np.uint8)[rng.integers(0, 4, n)].copy()
    for p in rng.integers(0, n - 30, 2000):
        codes[p : p + int(rng.integers(1, 25))] = ord("N")
    lanes, inv = pack_for_transfer(codec.seq_to_codes(codes), n)
    L = torch.from_numpy(lanes.view(np.int32)).to(dev)
    I = torch.from_numpy(inv.view(np.int32)).to(dev)
    err = 0.0
    for k in (15, 21, 31, 32):
        gk, gn = extract.extract_keys(L, I, k, n - 7)
        pk, pn = extract.extract_keys_plain(L, I, k, n - 7)
        err = max(err, max_abs_err(torch, gk, pk), abs(int(gn) - int(pn)))
        t_k = median_ms(torch, lambda: extract.extract_keys(L, I, k, n - 7))
        t_p = median_ms(torch, lambda: extract.extract_keys_plain(L, I, k, n - 7))
        log(f"K1 extract k={k} 2^24 positions: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, n_valid {int(gn)}")
        if k == 31:
            rec["K1"] = (t_k, t_p)
    check(err == 0, "K1 agrees with its plain version")
    rec["K1"] = (*rec["K1"], err)
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
    log(f"K2 merge 2^24 + 2^24 keys: kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
    rec["K2"] = (t_k, t_p)
    ta = torch.unique(sorted_keys(40_000_000, 1 << 40))
    tb = torch.unique(sorted_keys(9_000_000, 1 << 40))
    ca = torch.randint(1, 1000, ta.shape, device=dev)
    cb = torch.randint(1, 1000, tb.shape, device=dev)
    gk, gp = merge.merge(ta, tb, ca, cb)
    pk, pp = merge.merge_plain(ta, tb, ca, cb)
    err = max(err, max_abs_err(torch, gk, pk), max_abs_err(torch, gp, pp))
    t_k2 = median_ms(torch, lambda: merge.merge(ta, tb, ca, cb))
    t_p2 = median_ms(torch, lambda: merge.merge_plain(ta, tb, ca, cb))
    log(f"K2 merge {ta.shape[0]} + {tb.shape[0]} keys with counts: kernel {t_k2:.3f} ms, plain {t_p2:.3f} ms")
    check(err == 0, "K2 agrees with its plain version")
    rec["K2"] = (*rec["K2"], err)
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
        log(f"K3 compact 2^25 x 2 planes density {density}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
        if density == 0.5:
            rec["K3"] = (t_k, t_p)
    check(err == 0, "K3 agrees with its plain version")
    rec["K3"] = (*rec["K3"], err)
    torch.cuda.synchronize()
    log(f"launch counters after phase 3: K1 {extract.launches} K2 {merge.launches} K3 {compact.launches}")
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


def phase_exact(np, codec, work: Path, rng):
    from orion_kmer_tpu.db import KmerDb

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


def phase_realistic(np, torch, codec, work: Path, rng, gbp: float, dev):
    from orion_kmer_tpu_torch import cli
    from orion_kmer_tpu_torch.ops import compact, extract, merge

    fq = work / "reads.fastq"
    t0 = time.monotonic()
    n_reads, n_windows = write_reads_fastq(np, fq, rng, gbp)
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
    vals = parse_tsv_keys(np, codec, out.read_bytes(), 31)
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
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gbp", type=float, default=0.5, help="Gbp of reads in the realistic run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not (ROOT / "orion_kmer_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from orion_kmer_tpu import codec
    from orion_kmer_tpu.ingest import native
    from orion_kmer_tpu_torch import _kernels

    dev = torch.device("cuda")
    card = gpu_name_and_limit()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"native ingest available: {native.available()}")

    t0 = time.monotonic()
    _kernels.lib()
    log(f"phase 2 build: kernels built and loaded in {time.monotonic() - t0:.1f} s")

    rng = np.random.default_rng(args.seed)
    rec = phase_kernels(np, torch, codec, dev, rng)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the CLI subprocesses of phase 4 share the card
    log("phase 3 kernels: exact")

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        phase_exact(np, codec, work, rng)
        log("phase 4 exact run: passed")
        launches = phase_realistic(np, torch, codec, work, rng, args.gbp, dev)
        log("phase 5 realistic run: passed")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    pkg = "orion_kmer_tpu_torch/csrc"
    kernels = [
        ("K1 extract", f"{pkg}/extract.cu", "orion_kmer_tpu/ops/kmers_pallas.py:29"),
        ("K2 merge", f"{pkg}/merge.cu", "orion_kmer_tpu/ops/sort_pallas.py:222"),
        ("K3 compact", f"{pkg}/compact.cu", "orion_kmer_tpu/ops/sort_pallas.py:463"),
    ]
    out = []
    for name, source, replaces in kernels:
        key = name.split()[0]
        t_k, t_p, err = rec[key]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
        })
    log(card)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
