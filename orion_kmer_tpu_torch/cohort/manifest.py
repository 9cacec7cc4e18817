"""Readers for the bundled cohort datasets (reference P4).

The reference repo ships three data artifacts that define the benchmark
cohort (BASELINE.json configs 4-5):

  data_metagenome.json.gz   -- 195,922 ENA run records
  hybrid_biosamples.json    -- biosample -> short_reads[]/long_reads[]
  hybrid_data_summary.tsv   -- 4-column per-biosample summary

These helpers load them into plain structures and compute the cohort
statistics used to plan multi-sample profiling runs.
"""

from __future__ import annotations

import gzip
import json
from collections import Counter
from dataclasses import dataclass
from pathlib import Path


def load_run_records(path: str | Path) -> list[dict]:
    """Load the (optionally gzipped) ENA run-record JSON."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def load_hybrid_biosamples(path: str | Path) -> list[dict]:
    with open(path) as f:
        return json.load(f)


@dataclass
class CohortStats:
    n_runs: int
    n_studies: int
    n_samples: int
    total_reads: int
    total_bases: int
    platforms: dict[str, int]


def cohort_stats(records: list[dict]) -> CohortStats:
    platforms = Counter(r.get("instrument_platform", "UNKNOWN") for r in records)
    return CohortStats(
        n_runs=len(records),
        n_studies=len({r.get("study_accession") for r in records}),
        n_samples=len({r.get("sample_id") for r in records}),
        total_reads=sum(int(r.get("read_count") or 0) for r in records),
        total_bases=sum(int(r.get("base_count") or 0) for r in records),
        platforms=dict(platforms),
    )


def select_samples(
    records: list[dict],
    max_samples: int | None = None,
    platform: str | None = None,
    min_bases: int = 0,
) -> dict[str, list[dict]]:
    """Group run records by sample with optional filters -- the planning
    input for multi-sample profiling (BASELINE config 4)."""
    by_sample: dict[str, list[dict]] = {}
    for r in records:
        if platform and r.get("instrument_platform") != platform:
            continue
        if int(r.get("base_count") or 0) < min_bases:
            continue
        sid = r.get("sample_id")
        if sid:
            by_sample.setdefault(sid, []).append(r)
    if max_samples is not None:
        by_sample = dict(sorted(by_sample.items())[:max_samples])
    return by_sample
