"""Per-biosample summary TSV (reference summarize_hybrid.py equivalent).

Re-queries metadata per biosample batch, extracts sample type (organism),
environment (priority column list, ref:64-72) and the sorted instrument
set, and writes the 4-column TSV (BioSample ID / Sample Type /
Environment / Instruments).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

from .client import MetadataClient, default_client

logger = logging.getLogger("orion_kmer_tpu_torch.cohort.summarize")

ENV_COLUMNS = [  # priority order, summarize_hybrid.py:64
    "env_local_scale",
    "env_broad_scale",
    "isolation_source",
    "env_medium",
    "sample_name",
    "study_title",
]
_INVALID_VALUES = {"nan", "", "not applicable", "missing", "none"}


def _first_valid(values) -> str | None:
    for v in values:
        if v is None or v != v:
            continue
        s = str(v)
        if s.lower() not in _INVALID_VALUES:
            return s
    return None


def summarize_rows(rows: list[dict]) -> list[dict]:
    """Aggregate metadata rows (grouped by 'biosample') into summaries."""
    by_biosample: dict[str, list[dict]] = {}
    for row in rows:
        bs = row.get("biosample")
        if bs is None or bs != bs:
            continue
        by_biosample.setdefault(bs, []).append(row)

    out = []
    for biosample in sorted(by_biosample):
        group = by_biosample[biosample]
        sample_type = _first_valid(r.get("organism_name") for r in group) or "N/A"
        env = "N/A"
        for col in ENV_COLUMNS:
            v = _first_valid(r.get(col) for r in group)
            if v is not None:
                env = v
                break
        instruments = sorted(
            {
                str(r["instrument_model"])
                for r in group
                if r.get("instrument_model") is not None
                and r.get("instrument_model") == r.get("instrument_model")
            }
        )
        out.append(
            {
                "BioSample ID": biosample,
                "Sample Type": sample_type,
                "Environment": env,
                "Instruments": ", ".join(instruments) if instruments else "N/A",
            }
        )
    return out


def summarize_hybrid(
    input_file: str | Path = "hybrid_biosamples.json",
    output_file: str | Path = "hybrid_data_summary.tsv",
    client: MetadataClient | None = None,
    batch_size: int = 50,
    max_retries: int = 3,
    sleep=time.sleep,
) -> list[dict]:
    if client is None:
        client = default_client()
    with open(input_file) as f:
        data = json.load(f)
    biosamples = sorted({e["biosample"] for e in data if "biosample" in e})
    logger.info("Found %d unique BioSamples.", len(biosamples))

    results: list[dict] = []
    for i in range(0, len(biosamples), batch_size):
        batch = biosamples[i : i + batch_size]
        rows = None
        for attempt in range(max_retries):
            try:
                rows = client.sra_metadata(batch, detailed=True)
                break
            except Exception as e:  # noqa: BLE001 - mirror reference retry
                logger.warning("Attempt %d failed: %s", attempt + 1, e)
                sleep(2 * (attempt + 1))
        if rows is None:
            logger.error("Failed batch after %d attempts. Skipping.", max_retries)
            continue
        results.extend(summarize_rows(rows))

    # de-dup by biosample (summarize_hybrid.py:106)
    seen = set()
    unique = []
    for r in results:
        if r["BioSample ID"] not in seen:
            seen.add(r["BioSample ID"])
            unique.append(r)

    cols = ["BioSample ID", "Sample Type", "Environment", "Instruments"]
    with open(output_file, "w") as f:
        f.write("\t".join(cols) + "\n")
        for r in unique:
            f.write("\t".join(r[c] for c in cols) + "\n")
    logger.info("Summary saved to %s", output_file)
    return unique
