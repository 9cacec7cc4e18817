"""Sequencing platform classification.

Behavioral parity with the reference classifier
(find_hybrid_samples.py:47-62); the unit-test table in
test_find_hybrid_samples.py:5-15 is the spec.
"""

from __future__ import annotations

LONG_READ_MARKERS = (
    "NANOPORE",
    "MINION",
    "GRIDION",
    "PROMETHION",
    "PACBIO",
    "SEQUEL",
)

SHORT_READ_MARKERS = (
    "ILLUMINA",
    "HISEQ",
    "MISEQ",
    "NEXTSEQ",
    "NOVASEQ",
    "ION TORRENT",
    "BGISEQ",
    "DNBSEQ",
    "SOLID",
    "454",
    "AB 5500",
    "HELIOS",
)


def classify_platform(instrument_model) -> str:
    """'LONG', 'SHORT', or 'OTHER' for an instrument model string."""
    if not isinstance(instrument_model, str):
        return "OTHER"
    model = instrument_model.upper()
    if any(marker in model for marker in LONG_READ_MARKERS):
        return "LONG"
    if any(marker in model for marker in SHORT_READ_MARKERS):
        return "SHORT"
    return "OTHER"
