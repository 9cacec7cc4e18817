"""profile command: multi-sample k-mer profiling over a cohort manifest.

The port of ``orion_kmer_tpu/commands/profile.py`` (BASELINE.json config
4), wired to the port's ``count_file`` (K1-K3) and
``classify_against_databases`` (K2).  One invocation profiles every
sample: canonical k-mer counting, an optional FracMinHash sketch of the
counted values, optional classification against databases, with
per-sample wall time (samples/hr) and per-sample failure isolation (an
unreadable sample is recorded as "error" and the run goes on).  The
output equals the JAX package's apart from the wall times ``seconds``,
``elapsed_seconds`` and ``samples_per_hour``.

Manifest format (JSON):
  [{"sample": "S1", "files": ["a.fastq.gz", "b.fastq.gz"]}, ...]
or {"samples": [{...}]}.
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np

from ..db import KmerDb
from ..engine import count_file
from ..errors import ContextError, validate_k
from ..host import CountAccumulator
from ..ingest.compress import TextOut, read_bytes
from ..ingest.fastx import FastxParseError
from ..ops.hash import splitmix64_np
from ..utils import track_progress_and_resources
from .classify import classify_against_databases

logger = logging.getLogger("orion_kmer_tpu_torch.profile")


def load_manifest(path) -> list[dict]:
    try:
        doc = json.loads(read_bytes(path))
    except (ContextError, json.JSONDecodeError) as e:
        raise ContextError(f"Failed to load manifest: {path!r}", e) from e
    samples = doc["samples"] if isinstance(doc, dict) else doc
    out = []
    for entry in samples:
        if "sample" not in entry or "files" not in entry:
            raise ContextError(
                f"Manifest entries need 'sample' and 'files': got {entry!r}"
            )
        out.append({"sample": str(entry["sample"]), "files": list(entry["files"])})
    return out


def profile_sample(
    files: list[str], k: int, scaled: int | None, databases, min_coverage: float, device
) -> dict:
    acc = CountAccumulator()
    for f in files:
        vals, cnt = count_file(f, k, device)
        acc.add(vals, cnt.astype(np.int64, copy=False))
    vals, counts = acc.result()
    result = {
        "total_kmers": int(counts.sum()),
        "unique_kmers": int(vals.shape[0]),
        "max_multiplicity": int(counts.max()) if counts.shape[0] else 0,
    }
    if scaled:
        # the counted values are on the host already: hash them there
        h = splitmix64_np(vals)
        thr = np.uint64((1 << 64) // scaled) if scaled > 1 else None
        kept = np.sort(h) if thr is None else np.sort(h[h < thr])
        result["sketch"] = {
            "scaled": scaled,
            "hashes": [str(x) for x in kept.tolist()],
        }
    if databases:
        result["databases_analyzed"] = classify_against_databases(
            vals, counts, databases, min_coverage, device
        )
    return result


def run_profile(args, device) -> None:
    validate_k(args.kmer_size)
    k = args.kmer_size
    manifest = load_manifest(args.manifest)

    databases = []
    for db_path in args.database_files or []:
        db = KmerDb.load(db_path)
        if db.k != k:
            raise ContextError(
                f"Database {db_path!r} has k={db.k}, profile requested k={k}"
            )
        databases.append((str(db_path), db))

    profiles = []
    t_start = time.monotonic()

    def task(pb):
        for entry in manifest:
            name = entry["sample"]
            pb.set_message(f"Profiling: {name}")
            t0 = time.monotonic()
            record = {"sample": name, "files": entry["files"], "status": "ok"}
            try:
                record.update(
                    profile_sample(
                        entry["files"], k, args.scaled, databases, args.min_coverage, device
                    )
                )
            except (FastxParseError, ContextError, OSError) as e:
                logger.error("Sample %s failed: %s", name, e)
                record["status"] = "error"
                record["error"] = str(e)
            record["seconds"] = round(time.monotonic() - t0, 3)
            profiles.append(record)
            pb.inc(1)

    track_progress_and_resources("Profiling samples", len(manifest), task)

    elapsed = time.monotonic() - t_start
    n_ok = sum(1 for p in profiles if p["status"] == "ok")
    out = {
        "kmer_size": k,
        "scaled": args.scaled,
        "n_samples": len(manifest),
        "n_ok": n_ok,
        "n_error": len(manifest) - n_ok,
        "elapsed_seconds": round(elapsed, 3),
        "samples_per_hour": round(len(manifest) / elapsed * 3600, 2) if elapsed else 0,
        "profiles": profiles,
    }
    with TextOut(args.output_file) as f:
        json.dump(out, f, indent=2)
    logger.info(
        "Profiled %d/%d samples OK in %.1fs", n_ok, len(manifest), elapsed
    )
