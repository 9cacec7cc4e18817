"""Hybrid (short+long read) biosample finder.

Equivalent of the reference find_hybrid_samples.py: loads unique study
accessions from the gzipped run-record JSON (ref:29-45), fetches SRA
metadata in batches with retry/backoff (ref:64-83), groups runs per
biosample and keeps samples that have >=1 LONG and >=1 SHORT platform
run (ref:98-125), checkpointing results incrementally (ref:171-177).

Differences by design: batches run on a thread pool (the work is
network-bound; the reference used multiprocessing), and the metadata
client is injected (see cohort.client).
"""

from __future__ import annotations

import gzip
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

from .client import MetadataClient, default_client
from .platforms import classify_platform

logger = logging.getLogger("orion_kmer_tpu_torch.cohort.find_hybrid")

BATCH_SIZE = 50  # find_hybrid_samples.py:140
CHECKPOINT_EVERY = 5  # find_hybrid_samples.py:171
MAX_RETRIES = 3  # find_hybrid_samples.py:71


def load_studies(filepath: str | Path) -> list[str]:
    """Unique study accessions from the gzipped JSON (ref:29-45)."""
    opener = gzip.open if str(filepath).endswith(".gz") else open
    try:
        with opener(filepath, "rt", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        logger.error("Error loading studies: %s", e)
        return []
    studies = {
        entry["study_accession"] for entry in data if "study_accession" in entry
    }
    logger.info("Found %d unique studies.", len(studies))
    return sorted(studies)  # deterministic order (reference used set order)


def find_hybrid_in_rows(rows: list[dict]) -> list[dict]:
    """Group run rows by sample; keep samples with LONG and SHORT runs
    (ref:85-125 semantics, including the instrument fallback column)."""
    by_sample: dict[str, list[dict]] = {}
    for row in rows:
        sample = row.get("sample_accession")
        if sample is None or sample == "N/A" or sample != sample:  # NaN check
            continue
        by_sample.setdefault(sample, []).append(row)

    hybrid = []
    for sample_acc in by_sample:
        long_reads, short_reads = [], []
        for row in by_sample[sample_acc]:
            model = row.get("instrument_model", row.get("instrument"))
            platform = classify_platform(model)
            run_info = {
                "run_accession": row.get("run_accession"),
                "instrument_model": model,
                "study_accession": row.get("study_accession"),
            }
            if platform == "LONG":
                long_reads.append(run_info)
            elif platform == "SHORT":
                short_reads.append(run_info)
        if long_reads and short_reads:
            hybrid.append(
                {
                    "biosample": sample_acc,
                    "short_reads": short_reads,
                    "long_reads": long_reads,
                    "study_accession": sorted(
                        {r["study_accession"] for r in long_reads + short_reads}
                    ),
                }
            )
    return hybrid


def process_batch(
    studies: list[str],
    client: MetadataClient,
    max_retries: int = MAX_RETRIES,
    sleep=time.sleep,
) -> list[dict]:
    """Fetch one batch with linear-backoff retries (ref:70-83)."""
    rows = None
    for attempt in range(max_retries):
        try:
            rows = client.sra_metadata(studies, detailed=True)
            break
        except Exception as e:  # noqa: BLE001 - mirror reference's broad retry
            if attempt < max_retries - 1:
                sleep(2 * (attempt + 1))
            else:
                logger.error(
                    "Failed to process batch %s... after %d attempts: %s",
                    studies[:3],
                    max_retries,
                    e,
                )
                return []
    if not rows:
        return []
    # required columns check (ref:89-96)
    required = {"sample_accession", "run_accession", "study_accession"}
    present = set(rows[0].keys())
    if not required <= present:
        return []
    if "instrument_model" not in present and "instrument" not in present:
        return []
    return find_hybrid_in_rows(rows)


def find_hybrid_samples(
    input_file: str | Path = "data_metagenome.json.gz",
    output_file: str | Path = "hybrid_biosamples.json",
    limit: int | None = None,
    workers: int | None = None,
    client: MetadataClient | None = None,
    batch_size: int = BATCH_SIZE,
) -> list[dict]:
    """End-to-end finder with incremental checkpointing (ref:132-195).

    ``workers`` defaults to -t/--threads (ORION_KMER_THREADS), falling
    back to the reference's 4 (find_hybrid_samples.py:154)."""
    if workers is None:
        from ..utils.progress import worker_threads

        workers = worker_threads(default=4)
    if client is None:
        client = default_client()
    studies = load_studies(input_file)
    if not studies:
        logger.error("No studies found. Exiting.")
        return []
    if limit:
        studies = studies[:limit]

    batches = [studies[i : i + batch_size] for i in range(0, len(studies), batch_size)]
    all_hybrid: list[dict] = []

    def save():
        try:
            with open(output_file, "w") as f:
                json.dump(all_hybrid, f, indent=2)
        except OSError as e:
            logger.error("Error saving incremental results: %s", e)

    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(process_batch, b, client) for b in batches]
            for i, fut in enumerate(as_completed(futures)):
                result = fut.result()
                if result:
                    all_hybrid.extend(result)
                logger.info(
                    "Processed %d/%d batches. Found %d hybrid samples so far.",
                    i + 1,
                    len(batches),
                    len(all_hybrid),
                )
                if (i + 1) % CHECKPOINT_EVERY == 0:
                    save()
    except KeyboardInterrupt:
        logger.warning("Interrupted by user. Saving partial results...")

    save()
    logger.info("Total hybrid samples found: %d", len(all_hybrid))
    return all_hybrid
