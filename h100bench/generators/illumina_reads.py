"""Illumina-like reads of one bacterial genome, from the seed, on the
device.

The recipe of the repository's earlier chip smoke test, frozen here: one
random genome of ``genome_bp`` bases; ``gbp`` of ``read_len``-base reads
drawn uniformly from it, each from either strand with even odds;
substitutions at ``substitution_rate``; a run of 1 to ``n_run_max`` N in a
share ``n_read_share`` of the reads.  The FASTQ has fixed-width records
(``@r`` and a 9-digit index, the read, ``+``, a quality ``I`` per base),
written behind the generation into a file in memory (``Workdir.memory_file``): a
run reads its ~2 GB some tens of times and writes none of it to disk.  With ``references``, three more genomes
for a database: the genome itself, a strain of it at
``strain_substitution_rate``, and an unrelated one of ``unrelated_bp``.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.harness.inputs import BASES_N, Inputs, Writer, generator, substituted

HEAD_W = 12  # "@r" + 9 digits + "\n"


def _window_count(n_masks: list[np.ndarray], n_clean: int, read_len: int):
    masks = np.concatenate(n_masks) if n_masks else np.zeros((0, read_len), bool)

    def valid_windows(k: int) -> int:
        bad = np.concatenate([np.zeros((masks.shape[0], 1), np.int64), np.cumsum(masks, axis=1)], axis=1)
        return n_clean * (read_len - k + 1) + int(((bad[:, k:] - bad[:, :-k]) == 0).sum())

    return valid_windows


def make(cfg: dict, seed: int, workdir, device) -> Inputs:
    L = cfg["read_len"]
    G = cfg["genome_bp"]
    n_reads = int(round(cfg["gbp"] * 1e9)) // L
    if n_reads >= 10**9:
        raise ValueError("read ids have 9 digits")
    block = cfg.get("block_reads", 1 << 20)
    n_max = cfg["n_run_max"]
    width = HEAD_W + 2 * L + 4
    genome = torch.randint(0, 4, (G,), generator=generator(device, seed, "genome"), device=device, dtype=torch.uint8)
    ar = torch.arange(L, device=device)
    lut = torch.tensor(list(BASES_N), dtype=torch.uint8, device=device)
    digit_div = torch.tensor([10 ** (8 - d) for d in range(9)], device=device)
    n_masks = []
    path = workdir.memory_file("reads.fastq")
    out = Writer(path)
    try:
        for b, lo in enumerate(range(0, n_reads, block)):
            m = min(block, n_reads - lo)
            g = generator(device, seed, f"reads/{b}")
            starts = torch.randint(0, G - L, (m,), generator=g, device=device)
            reads = genome[starts[:, None] + ar]
            rev = torch.rand(m, generator=g, device=device) < 0.5
            reads = torch.where(rev[:, None], 3 - reads.flip(1), reads)
            reads = substituted(reads, cfg["substitution_rate"], g)
            has_n = torch.rand(m, generator=g, device=device) < cfg["n_read_share"]
            p = torch.randint(0, L - n_max, (m,), generator=g, device=device)
            ln = torch.randint(1, n_max + 1, (m,), generator=g, device=device)
            in_run = has_n[:, None] & (ar >= p[:, None]) & (ar < (p + ln)[:, None])
            reads = reads.masked_fill(in_run, 4)
            n_masks.append(in_run[has_n].cpu().numpy())
            rows = torch.empty((m, width), dtype=torch.uint8, device=device)
            rows[:, 0] = ord("@")
            rows[:, 1] = ord("r")
            ids = lo + torch.arange(m, device=device)
            rows[:, 2:11] = (ord("0") + (ids[:, None] // digit_div) % 10).to(torch.uint8)
            rows[:, 11] = ord("\n")
            rows[:, HEAD_W : HEAD_W + L] = lut[reads.long()]
            rows[:, HEAD_W + L : HEAD_W + L + 3] = torch.tensor(list(b"\n+\n"), dtype=torch.uint8, device=device)
            rows[:, HEAD_W + L + 3 : width - 1] = ord("I")
            rows[:, width - 1] = ord("\n")
            out.write(rows.cpu().numpy())
            del reads, rows, in_run
    finally:
        out.close()
    n_with_n = sum(x.shape[0] for x in n_masks)
    inputs = Inputs(
        reads_path=path,
        read_len=L,
        head_w=HEAD_W,
        n_reads=n_reads,
        bases=n_reads * L,
        valid_windows=_window_count(n_masks, n_reads - n_with_n, L),
        reads_with_n=n_with_n,
        genomes={},
    )
    refs = cfg.get("references")
    if refs:
        strain = substituted(genome, refs["strain_substitution_rate"], generator(device, seed, "strain"))
        unrelated = torch.randint(0, 4, (refs["unrelated_bp"],), generator=generator(device, seed, "unrelated"),
                                  device=device, dtype=torch.uint8)
        inputs.genomes = {
            "genomeA.fa": genome.cpu().numpy(),
            "genomeB.fa": strain.cpu().numpy(),
            "genomeC.fa": unrelated.cpu().numpy(),
        }
    return inputs
