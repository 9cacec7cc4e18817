"""query command: match reads against a KmerDb.

The port of ``orion_kmer_tpu/commands/query.py``, wired to the port's
``query_lines`` (``query_file``'s ids as lines; K1 extraction, K2 join).  Parity target: orion-kmer `query` (commands/query.rs:24-134).
Semantics: raw (unnormalized) read bytes (query.rs:80-81); window hits
counted WITH multiplicity (query_tests.rs:121-125); reads shorter than k
dropped (query.rs:83-85); output = matching read IDs, one per line, in
input order.
"""

from __future__ import annotations

import logging

from ..db import KmerDb
from ..engine import query_lines
from ..errors import ContextError, validate_k
from ..ingest.compress import open_output
from ..ingest.fastx import FastxParseError
from ..utils import track_progress_and_resources

logger = logging.getLogger("orion_kmer_tpu_torch.query")


def run_query(args, device) -> None:
    db = KmerDb.load(args.database_file)
    k = db.k
    validate_k(k)

    db_all = db.get_all_kmers_unified()
    logger.info(
        "Querying reads from %s against database with k=%d (%d unique k-mers in DB)",
        args.reads_file,
        k,
        db_all.shape[0],
    )

    def task(pb):
        try:
            return query_lines(db_all, args.reads_file, k, args.min_hits, device)
        except FastxParseError as e:
            raise ContextError(
                f"Failed to open or parse FASTQ file: \"{args.reads_file}\"", e
            ) from e

    lines = track_progress_and_resources(
        "Querying reads against database", 0, task
    )

    logger.info(
        "Found %d reads matching criteria (min_hits: %d).", lines.count(b"\n"), args.min_hits
    )
    with open_output(args.output_file) as f:
        f.write(lines)
