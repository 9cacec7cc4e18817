"""SRA metadata client abstraction.

The reference talks to NCBI through pysradb (find_hybrid_samples.py:67,
summarize_hybrid.py:28).  That dependency is not available in every
environment (and this engine's compute path must never depend on it), so
metadata access goes through a tiny interface: a client is any object
with ``sra_metadata(accessions: list[str], detailed: bool) ->
list[dict]`` returning one dict per run row.

``default_client()`` returns a pysradb-backed client when the library is
importable, otherwise raises with a clear message.  Tests inject fakes.
"""

from __future__ import annotations

from typing import Protocol


class MetadataClient(Protocol):
    def sra_metadata(self, accessions: list[str], detailed: bool = True) -> list[dict]:
        ...


class PysradbClient:
    """pysradb-backed client (rows as list[dict] instead of DataFrame)."""

    def __init__(self):
        from pysradb.sraweb import SRAweb  # gated import

        self._db = SRAweb()

    def sra_metadata(self, accessions, detailed=True):
        df = self._db.sra_metadata(accessions, detailed=detailed)
        if df is None or df.empty:
            return []
        return df.to_dict(orient="records")


def default_client() -> MetadataClient:
    try:
        return PysradbClient()
    except ImportError as e:
        raise RuntimeError(
            "No SRA metadata client available: pysradb is not installed. "
            "Pass an explicit client implementing sra_metadata()."
        ) from e
