"""count command: canonical k-mer counting over FASTA/FASTQ inputs.

The port of ``orion_kmer_tpu/commands/count.py`` (parity target:
orion-kmer ``count``, commands/count.rs:40-141), wired to the port's
``count_file``.  Output: ``KMER\\tCOUNT`` lines, count >= min_count,
sorted ascending by the encoded u64 (== lexicographic string order).
"""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np

from .. import codec
from ..engine import count_file
from ..errors import ContextError, validate_k
from ..host import CountAccumulator
from ..ingest import native
from ..ingest.compress import TextOut
from ..ingest.fastx import FastxParseError
from ..utils import track_progress_and_resources
from ..utils.progress import worker_threads

logger = logging.getLogger("orion_kmer_tpu_torch.count")


def write_counts_tsv(path, vals: np.ndarray, counts: np.ndarray, k: int,
                     min_count: int | None = None, histogram=None) -> None:
    """Write sorted ``kmer\\tcount`` lines (count.rs:127-135) of the rows
    with count >= ``min_count`` (every row when None) to ``path`` and,
    when ``histogram`` names a file, ``write_histogram``'s lines of every
    row's count there.

    Natively, the filter, the histogram and the render are one pass
    (``native.render_counts``) spread over -t threads (ORION_KMER_THREADS);
    else the numpy filter, ``write_histogram`` and the codec's render.
    The histogram stays whole, as it is written before the filter, when
    the TSV fails."""
    if not native.available():
        if histogram is not None:
            write_histogram(histogram, counts)
        if min_count is not None:
            keep = counts >= min_count
            vals, counts = vals[keep], counts[keep]
        with TextOut(path) as f:
            chunk = 1 << 16
            for start in range(0, vals.shape[0], chunk):
                seqs = codec.u64s_to_seqs(vals[start : start + chunk], k)
                cnts = counts[start : start + chunk].tolist()
                f.write("".join(f"{s.decode('ascii')}\t{c}\n" for s, c in zip(seqs, cnts)))
        return
    with contextlib.ExitStack() as stack:
        hist_out = None if histogram is None else stack.enter_context(TextOut(histogram))
        try:
            with TextOut(path) as f:
                f.flush()  # nothing buffered yet; keep text/binary ordering safe
                rows = native.render_counts(
                    f.buffer.write, vals, counts, k, min_count, hist_out is not None, worker_threads()
                )
        except (ContextError, OSError):
            if hist_out is not None:
                _write_histogram_rows(hist_out, *np.unique(counts, return_counts=True))
            raise
        if hist_out is not None:
            _write_histogram_rows(hist_out, *rows)


def _load_checkpoint(path, k):
    """Resume state: previously merged counts + the set of finished files."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if int(z["k"]) != k:
                logger.warning(
                    "Checkpoint %s has k=%d (expected %d); ignoring", path, z["k"], k
                )
                return None
            return z["vals"], z["counts"], set(z["files_done"].tolist())
    except (OSError, KeyError, ValueError) as e:
        logger.warning("Could not read checkpoint %s (%s); ignoring", path, e)
        return None


def _save_checkpoint(path, k, vals, counts, files_done):
    tmp = str(path) + ".tmp.npz"  # .npz suffix so numpy doesn't append one
    np.savez_compressed(
        tmp,
        k=np.int64(k),
        vals=vals,
        counts=counts,
        files_done=np.array(sorted(files_done), dtype=str),
    )
    os.replace(tmp, path)


def write_histogram(path, counts: np.ndarray) -> None:
    """Write ``multiplicity\\tdistinct_kmers`` lines (jellyfish-histo
    style), computed over ALL counted k-mers (before the min-count
    filter)."""
    with TextOut(path) as f:
        if counts.shape[0]:
            _write_histogram_rows(f, *np.unique(counts, return_counts=True))


def _write_histogram_rows(f, multiplicities: np.ndarray, freq: np.ndarray) -> None:
    f.write("".join(f"{m}\t{c}\n" for m, c in zip(multiplicities.tolist(), freq.tolist())))


def run_count(args, device) -> None:
    validate_k(args.kmer_size)
    k = args.kmer_size

    acc = CountAccumulator()
    ckpt_path = getattr(args, "checkpoint", None)
    files_done: set[str] = set()
    resumed = _load_checkpoint(ckpt_path, k)
    if resumed is not None:
        vals0, counts0, files_done = resumed
        acc.add(vals0, counts0)
        logger.info(
            "Resumed checkpoint %s: %d k-mers, %d files done",
            ckpt_path,
            vals0.shape[0],
            len(files_done),
        )

    def task(pb):
        nonlocal acc
        for input_path in args.input_files:
            if str(input_path) in files_done:
                logger.info("Skipping already-counted file: %s", input_path)
                pb.inc(1)
                continue
            logger.info("Processing file: %s", input_path)
            pb.set_message(f"Processing: {input_path}")
            try:
                vals, cnt = count_file(input_path, k, device)
            except FastxParseError as e:
                raise ContextError(
                    f"Failed to open or parse file: {input_path}", e
                ) from e
            acc.add(vals, cnt.astype(np.int64, copy=False))
            files_done.add(str(input_path))
            if ckpt_path:
                # the merged table doubles as the resumable checkpoint
                merged_vals, merged_counts = acc.result()
                acc = CountAccumulator()
                acc.add(merged_vals, merged_counts)
                _save_checkpoint(ckpt_path, k, merged_vals, merged_counts, files_done)
            pb.inc(1)

    track_progress_and_resources(
        "Counting k-mers from input files", len(args.input_files), task
    )

    vals, counts = acc.result()
    logger.info("Writing k-mers with count >= %d to output file...", args.min_count)
    write_counts_tsv(args.output_file, vals, counts, k, args.min_count, getattr(args, "histogram", None))
