"""compare command: Jaccard similarity between two KmerDb files.

The port of ``orion_kmer_tpu/commands/compare.py``, wired to the
port's ``intersection_size_host`` (one K2 merge).  Parity target: orion-kmer `compare` (commands/compare.rs:29-97).
JSON field names mirror compare.rs:16-25 exactly (the README's short
names are stale; code+tests are authoritative, compare_tests.rs:99-108).
The JSON output is written uncompressed regardless of extension, exactly
like the reference's File::create path (compare.rs:85-89).
"""

from __future__ import annotations

import json
import logging

from ..db import KmerDb
from ..engine import intersection_size_host
from ..errors import ContextError, KmerSizeMismatch
from ..utils import track_progress_and_resources

logger = logging.getLogger("orion_kmer_tpu_torch.compare")


def run_compare(args, device) -> None:
    db1 = KmerDb.load(args.db1)
    db2 = KmerDb.load(args.db2)

    if db1.k != db2.k:
        raise KmerSizeMismatch(db1.k, db2.k)
    kmer_size = db1.k

    def task(pb):
        a = db1.get_all_kmers_unified(device)
        b = db2.get_all_kmers_unified(device)
        inter = intersection_size_host(a, b, device)
        union = a.shape[0] + b.shape[0] - inter
        jaccard = (inter / union) if union else 0.0  # compare.rs:62-66
        pb.inc(1)
        return {
            "db1_path": str(args.db1),
            "db2_path": str(args.db2),
            "kmer_size": kmer_size,
            "db1_total_unique_kmers_across_references": int(a.shape[0]),
            "db2_total_unique_kmers_across_references": int(b.shape[0]),
            "intersection_size": int(inter),
            "union_size": int(union),
            "jaccard_index": jaccard,
        }

    output = track_progress_and_resources(
        f"Comparing databases: {args.db1} and {args.db2}", 1, task
    )

    logger.info("Comparison results: %s", output)
    try:
        with open(args.output_file, "w") as f:
            json.dump(output, f, indent=2)
    except OSError as e:
        raise ContextError(
            f"Failed to create output JSON file: {args.output_file!r}", e
        ) from e
