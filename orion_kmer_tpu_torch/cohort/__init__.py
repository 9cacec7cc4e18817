"""Cohort / metadata tooling (host-side Python, like the reference's).

The port's own copy of ``orion_kmer_tpu/cohort``: nothing here touches
the device, and nothing imports the JAX package.

Equivalents of the reference repo-root scripts (SURVEY.md section 2.2):
  platforms  -- instrument-model platform classifier (P1 core logic)
  find_hybrid-- hybrid (short+long read) biosample finder (P1)
  summarize  -- per-biosample summary TSV (P2)
  entrez     -- NCBI eutils query client (P3)
  manifest   -- readers for the bundled cohort datasets (P4)

Network access (pysradb / NCBI HTTP) is injected behind a MetadataClient
interface so all logic is testable offline; live clients are constructed
lazily and gated on library availability.
"""

from .platforms import classify_platform

__all__ = ["classify_platform"]
