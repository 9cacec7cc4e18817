"""classify command: multi-DB coverage/depth profiling of an input.

The port of ``orion_kmer_tpu/commands/classify.py``, wired to the
port's ``count_file`` (K1-K3) and ``ClassifyJoiner`` (K2).  Parity target: orion-kmer `classify` (commands/classify.rs:56-385):
  1. load DBs, resolve effective k (user k validates all DBs, else k of
     the first DB validates the rest; classify.rs:66-132)
  2. count input canonical k-mers, filter by --min-kmer-frequency
     (classify.rs:135-199)
  3. per DB x reference: matched input k-mers, sum/avg depth, breadth,
     proportions; reference included iff breadth >= --min-coverage;
     per-DB overall stats over the union of matched k-mers
     (classify.rs:215-308)
  4. pretty JSON (field names classify.rs:22-52) + optional 9-column TSV
     with {:.4} floats (classify.rs:338-381)

Improvement over the reference: references are emitted in sorted-name
order (the Rust HashMap order is nondeterministic, SURVEY.md section 3.5)
-- a strict superset of the reference's guarantee.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from ..db import KmerDb
from ..engine import ClassifyJoiner, count_file
from ..errors import (
    ContextError,
    GenericError,
    InvalidKmerSize,
    KmerSizeMismatchBetweenDatabases,
    KmerSizeMismatchValidation,
    validate_k,
)
from ..ingest.compress import TextOut
from ..ingest.fastx import FastxParseError
from ..utils import track_progress_and_resources

logger = logging.getLogger("orion_kmer_tpu_torch.classify")


def run_classify(args, device) -> None:
    # --- 1. Load databases and determine/validate k ---
    databases: list[tuple[str, KmerDb]] = []
    # k validation order matches the reference: user k is checked per-DB
    # as each database loads (classify.rs:77-115).
    final_k: int | None = None
    user_provided = args.kmer_size is not None
    if user_provided:
        validate_k(args.kmer_size)
        final_k = args.kmer_size
    for db_path in args.database_files:
        try:
            db = KmerDb.load(db_path)
        except ContextError as e:
            raise ContextError(f"Failed to load database: {db_path!r}", e) from e
        if final_k is not None:
            if db.k != final_k:
                if user_provided:
                    raise KmerSizeMismatchValidation(final_k, db.k, str(db_path))
                raise KmerSizeMismatchBetweenDatabases(final_k, db.k, str(db_path))
        else:
            if db.k < 1 or db.k > 32:
                raise InvalidKmerSize(db.k)
            final_k = db.k
        databases.append((str(db_path), db))
    if final_k is None:
        raise GenericError("No databases provided to determine k-mer size.")
    k = final_k
    logger.info("Processing with effective k-mer size: %d", k)

    # --- 2. Count input k-mers ---
    def count_task(pb):
        try:
            return count_file(args.input_file, k, device)
        except FastxParseError as e:
            raise ContextError(
                f"Failed to open or parse FASTA/Q content from: {args.input_file!r}", e
            ) from e

    input_vals, input_counts = track_progress_and_resources(
        f"Processing input file: {args.input_file}", 0, count_task
    )

    # frequency filter (classify.rs:196-199)
    keep = input_counts >= args.min_kmer_frequency
    input_vals, input_counts = input_vals[keep], input_counts[keep]
    total_unique_input = int(input_vals.shape[0])
    logger.info(
        "After min_kmer_frequency filter (>= %d), %d unique k-mers remain.",
        args.min_kmer_frequency,
        total_unique_input,
    )

    # --- 3. Classification ---
    def classify_task(pb):
        return classify_against_databases(
            input_vals, input_counts, databases, args.min_coverage, device, pb
        )

    db_results = track_progress_and_resources(
        "Classifying against databases", len(databases), classify_task
    )

    final_output = {
        "input_file_path": str(args.input_file),
        "total_unique_kmers_in_input": total_unique_input,
        "min_kmer_frequency_filter": args.min_kmer_frequency,
        "databases_analyzed": db_results,
    }

    # --- 4. JSON output (via extension-aware writer, classify.rs:323) ---
    with TextOut(args.output_file) as f:
        json.dump(final_output, f, indent=2)

    # --- 5. Optional TSV (classify.rs:338-381) ---
    if args.output_tsv:
        write_classify_tsv(args.output_tsv, final_output)

    logger.info("Classification successfully completed.")


def classify_against_databases(
    input_vals, input_counts, databases, min_coverage, device, pb=None
):
    """Per-DB x per-reference coverage/depth stats (classify.rs:215-308).

    ``databases`` is a list of (path_str, KmerDb).

    The per-reference probe loop of the reference (classify.rs:224-236)
    is batched: all references of a database are concatenated (chunked
    at ClassifyJoiner.MAX_JOIN k-mers) and joined against the input
    table in O(1) joins per DB -- the input table itself is shipped to
    the device once for the whole run.
    """
    total_unique_input = int(input_vals.shape[0])
    joiner = ClassifyJoiner(input_vals, input_counts, device)
    db_results = []
    for db_path_str, db in databases:
        if pb is not None:
            pb.set_message(f"Classifying against: {db_path_str}")
        overall_mask = np.zeros(total_unique_input, dtype=bool)
        per_ref = []
        # sorted order: deterministic superset of the reference
        names = sorted(db.references)
        chunks: list[list[str]] = []
        cur: list[str] = []
        cur_size = 0
        for nm in names:
            sz = int(db.references[nm].shape[0])
            if cur and cur_size + sz > ClassifyJoiner.MAX_JOIN:
                chunks.append(cur)
                cur, cur_size = [], 0
            cur.append(nm)
            cur_size += sz
        if cur:
            chunks.append(cur)
        for chunk in chunks:
            segs = [db.references[nm] for nm in chunk]
            offs = np.cumsum([0] + [s.shape[0] for s in segs])
            concat = (
                np.concatenate(segs) if segs else np.empty(0, np.uint64)
            )
            member_q, member_db = joiner.join(concat)
            overall_mask |= member_db
            for i, ref_name in enumerate(chunk):
                seg = slice(int(offs[i]), int(offs[i + 1]))
                m = member_q[seg]
                n_matched = int(m.sum())
                sum_depth = joiner.depth_of(concat[seg][m])
                total_in_ref = int(offs[i + 1] - offs[i])
                breadth = (n_matched / total_in_ref) if total_in_ref else 0.0
                if breadth < min_coverage:  # classify.rs:247
                    continue
                per_ref.append(
                    {
                        "reference_name": ref_name,
                        "total_kmers_in_reference": total_in_ref,
                        "input_kmers_hitting_reference": n_matched,
                        "sum_depth_of_matched_kmers_in_input": sum_depth,
                        "avg_depth_of_matched_kmers_in_input": (
                            sum_depth / n_matched if n_matched else 0.0
                        ),
                        "proportion_input_kmers_hitting_reference": (
                            n_matched / total_unique_input
                            if total_unique_input
                            else 0.0
                        ),
                        "reference_breadth_of_coverage": breadth,
                    }
                )
        overall_matched = int(overall_mask.sum())
        overall_depth = int(input_counts[overall_mask].sum())
        total_in_db = db.total_unique_kmers()
        db_results.append(
            {
                "database_path": db_path_str,
                "database_kmer_size": db.k,
                "total_unique_kmers_in_db_across_references": total_in_db,
                "overall_input_kmers_matched_in_db": overall_matched,
                "overall_sum_depth_of_matched_kmers_in_input": overall_depth,
                "overall_avg_depth_of_matched_kmers_in_input": (
                    overall_depth / overall_matched if overall_matched else 0.0
                ),
                "proportion_input_kmers_in_db_overall": (
                    overall_matched / total_unique_input
                    if total_unique_input
                    else 0.0
                ),
                "proportion_db_kmers_covered_overall": (
                    overall_matched / total_in_db if total_in_db else 0.0
                ),
                "references": per_ref,
            }
        )
        if pb is not None:
            pb.inc(1)
    return db_results


def write_classify_tsv(path, final_output) -> None:
    """9-column TSV with {:.4} float formatting (classify.rs:338-381)."""
    with TextOut(path) as f:
        f.write(
            "InputFile\tDatabase\tReference\tTotalKmersInReference\t"
            "InputKmersHittingReference\tSumDepthMatchedKmers\t"
            "AvgDepthMatchedKmers\tProportionInputKmersHittingReference\t"
            "ReferenceBreadthOfCoverage\n"
        )
        for db_res in final_output["databases_analyzed"]:
            for ref_res in db_res["references"]:
                f.write(
                    "\t".join(
                        [
                            final_output["input_file_path"],
                            db_res["database_path"],
                            ref_res["reference_name"],
                            str(ref_res["total_kmers_in_reference"]),
                            str(ref_res["input_kmers_hitting_reference"]),
                            str(ref_res["sum_depth_of_matched_kmers_in_input"]),
                            f"{ref_res['avg_depth_of_matched_kmers_in_input']:.4f}",
                            f"{ref_res['proportion_input_kmers_hitting_reference']:.4f}",
                            f"{ref_res['reference_breadth_of_coverage']:.4f}",
                        ]
                    )
                    + "\n"
                )
