"""sketch / sketch-compare commands (FracMinHash; BASELINE.json config 3).

The port of ``orion_kmer_tpu/commands/sketch.py``, wired to the port's
``ops.sketch.sketch_packed`` (K1, the hash and keep chain, K3).  The
signature file is a small JSON document, byte-equal to the JAX
package's:

  {"format": "orion-kmer-tpu-sketch", "version": 1, "k": 31,
   "scaled": 1000, "num": 0,
   "sketches": [{"name": ..., "hashes": [...], "abundances": [...]}]}

Hashes are splitmix64 of the canonical k-mer, decimal-encoded strings
(JSON numbers lose precision above 2^53).
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch

from ..errors import ContextError, validate_k
from ..host import CountAccumulator, _prefetch, batch_for
from ..ingest.compress import TextOut, read_bytes
from ..ingest.fastx import FastxParseError
from ..keys import u64_from_keys
from ..ops.sketch import pairwise_intersections, sketch_packed
from ..staging import staged_batches
from ..utils import track_progress_and_resources

logger = logging.getLogger("orion_kmer_tpu_torch.sketch")


def sketch_file(path, k: int, scaled: int, device, num: int = 0, batch_positions: int | None = None):
    """FracMinHash sketch of one FASTA/FASTQ file on ``device`` ->
    (u64 hashes ascending, int64 abundances).  Batches are parsed, packed
    and staged on the prefetch thread, as in ``engine.count_file``.

    With ``num`` set, the accumulator is consolidated and truncated to the
    bottom-num distinct hashes every 8 batches: once num smaller hashes
    exist they persist (hashes only accumulate), so a dropped hash can
    never re-enter the bottom-num, and memory stays O(num)."""
    device = torch.device(device)
    batch = batch_for(k, device, batch_positions)
    acc = CountAccumulator()
    batches_since_trim = 0
    for lanes, inv_words, _size, n in _prefetch(staged_batches(path, k, True, batch, device)):
        hashes, counts = sketch_packed(lanes, inv_words, k, n, scaled)
        acc.add(u64_from_keys(hashes), counts.cpu().numpy())
        batches_since_trim += 1
        if num and batches_since_trim >= 8:
            h, a = acc.result()
            acc = CountAccumulator()
            acc.add(h[:num], a[:num])
            batches_since_trim = 0
    hashes, abund = acc.result()
    if num and hashes.shape[0] > num:
        # bottom-num MinHash on top of the scaled subsample
        hashes, abund = hashes[:num], abund[:num]
    return hashes, abund


def run_sketch(args, device) -> None:
    validate_k(args.kmer_size)
    k = args.kmer_size

    sketches = []

    def task(pb):
        for path in args.input_files:
            pb.set_message(f"Sketching: {path}")
            try:
                hashes, abund = sketch_file(path, k, args.scaled, device, args.num)
            except FastxParseError as e:
                raise ContextError(f"Failed to open or parse file: {path}", e) from e
            sketches.append(
                {
                    "name": str(path),
                    "hashes": [str(h) for h in hashes.tolist()],
                    "abundances": abund.tolist(),
                }
            )
            pb.inc(1)

    track_progress_and_resources("Sketching input files", len(args.input_files), task)

    doc = {
        "format": "orion-kmer-tpu-sketch",
        "version": 1,
        "k": k,
        "scaled": args.scaled,
        "num": args.num,
        "sketches": sketches,
    }
    with TextOut(args.output_file) as f:
        json.dump(doc, f, indent=2)
    logger.info("Wrote %d sketches to %s", len(sketches), args.output_file)


def load_sketch_file(path) -> dict:
    try:
        doc = json.loads(read_bytes(path))
    except (ContextError, json.JSONDecodeError) as e:
        raise ContextError(f"Failed to load sketch file: {path!r}", e) from e
    if doc.get("format") != "orion-kmer-tpu-sketch":
        raise ContextError(f"Not an orion-kmer-tpu sketch file: {path!r}")
    return doc


def run_sketch_compare(args, device) -> None:
    """All-pairs Jaccard and containment of the sketches (host work:
    ``device`` is not used)."""
    docs = [load_sketch_file(p) for p in args.sketch_files]
    k = docs[0]["k"]
    scaled = docs[0]["scaled"]
    for p, d in zip(args.sketch_files, docs):
        if d["k"] != k or d["scaled"] != scaled:
            raise ContextError(
                f"Sketch parameter mismatch: {p!r} has k={d['k']} scaled={d['scaled']}, "
                f"expected k={k} scaled={scaled}"
            )
    entries = []
    for d in docs:
        for s in d["sketches"]:
            # np.unique: the writer emits sorted-unique hashes, but a
            # hand-edited .sig with duplicates would break the set
            # semantics of the pairwise join -- enforce both at load
            entries.append(
                (
                    s["name"],
                    np.unique(np.array([int(h) for h in s["hashes"]], dtype=np.uint64)),
                )
            )

    # all-pairs intersections from ONE sort of the concatenated hash lists
    inter_mat = pairwise_intersections([e[1] for e in entries])
    pairs = []
    for i in range(len(entries)):
        na = entries[i][1].shape[0]
        for j in range(i + 1, len(entries)):
            nb = entries[j][1].shape[0]
            inter = int(inter_mat[i, j])
            union = na + nb - inter
            pairs.append(
                {
                    "intersection": inter,
                    "union": int(union),
                    "jaccard": (inter / union) if union else 0.0,
                    "containment_a_in_b": (inter / na) if na else 0.0,
                    "containment_b_in_a": (inter / nb) if nb else 0.0,
                    "a": entries[i][0],
                    "b": entries[j][0],
                }
            )

    out = {
        "k": k,
        "scaled": scaled,
        "num_sketches": len(entries),
        "pairs": pairs,
    }
    with TextOut(args.output_file) as f:
        json.dump(out, f, indent=2)
    logger.info("Wrote %d pairwise comparisons to %s", len(pairs), args.output_file)
