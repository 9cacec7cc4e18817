"""build command: per-genome unique canonical k-mer sets -> KmerDb file.

The port of ``orion_kmer_tpu/commands/build.py`` (parity target:
orion-kmer ``build``, commands/build.rs:80-160), wired to the port's
``count_file``.  Reference name = input file basename including
extensions; the DB is serialized bincode-compatibly by ``db.py`` and
compressed by output extension.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..db import KmerDb
from ..engine import count_file
from ..errors import ContextError, validate_k
from ..ingest.fastx import FastxParseError
from ..utils import track_progress_and_resources

logger = logging.getLogger("orion_kmer_tpu_torch.build")


def _load_build_checkpoint(path, k):
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if int(z["k"]) != k:
                logger.warning(
                    "Checkpoint %s has k=%d (expected %d); ignoring", path, z["k"], k
                )
                return None
            files_done = set(z["files_done"].tolist())
            refs = {}
            n = int(z["n_refs"])
            for i in range(n):
                refs[str(z[f"ref_{i}_name"])] = z[f"ref_{i}_kmers"]
            return refs, files_done
    except (OSError, KeyError, ValueError) as e:
        logger.warning("Could not read checkpoint %s (%s); ignoring", path, e)
        return None


def _save_build_checkpoint(path, db: KmerDb, files_done):
    payload = {
        "k": np.int64(db.k),
        "files_done": np.array(sorted(files_done), dtype=str),
        "n_refs": np.int64(len(db.references)),
    }
    for i, (name, kmers) in enumerate(db.references.items()):
        payload[f"ref_{i}_name"] = np.str_(name)
        payload[f"ref_{i}_kmers"] = kmers
    tmp = str(path) + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def run_build(args, device) -> None:
    validate_k(args.kmer_size)
    k = args.kmer_size

    db = KmerDb(k=k)
    ckpt_path = getattr(args, "checkpoint", None)
    files_done: set[str] = set()
    resumed = _load_build_checkpoint(ckpt_path, k)
    if resumed is not None:
        refs, files_done = resumed
        for name, kmers in refs.items():
            db.add_reference(name, kmers)
        logger.info(
            "Resumed checkpoint %s: %d references, %d files done",
            ckpt_path,
            len(refs),
            len(files_done),
        )

    def task(pb):
        for input_path in args.genome_files:
            if str(input_path) in files_done:
                logger.info("Skipping already-built file: %s", input_path)
                pb.inc(1)
                continue
            try:
                kmers, _ = count_file(input_path, k, device)
            except FastxParseError as e:
                raise ContextError(
                    f"Failed to open or parse FASTA/Q file: {input_path}", e
                ) from e
            reference_name = os.path.basename(str(input_path)) or str(input_path)
            logger.info(
                "Adding %d unique k-mers from reference '%s' to the database.",
                kmers.shape[0],
                reference_name,
            )
            db.add_reference(reference_name, kmers)
            files_done.add(str(input_path))
            if ckpt_path:
                _save_build_checkpoint(ckpt_path, db, files_done)
            pb.set_message(f"Processed: {reference_name}")
            pb.inc(1)

    track_progress_and_resources(
        "Building k-mer database", len(args.genome_files), task
    )

    logger.info(
        "Database contains %d references and %d total unique canonical k-mers.",
        db.num_references(),
        db.total_unique_kmers(device),
    )
    try:
        db.save(args.output_file)
    except OSError as e:
        raise ContextError(
            f"Failed to get output writer for database file: {args.output_file!r}", e
        ) from e
