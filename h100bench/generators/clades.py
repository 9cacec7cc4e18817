"""Bacterial genome assemblies in clades, from the seed, on the device.

The recipe of the repository's earlier chip smoke test, frozen here:
``n_clades`` random ancestors of ``genome_bp`` bases, and
``n_genomes / n_clades`` genomes of each, the ancestor with substitutions
at rates spaced evenly on a log scale from ``min_rate`` to ``max_rate``,
so two genomes share from ~0 (two clades) to ~0.9 of their k-mers.  One
FASTA file a genome, named ``clade<c>_g<j>.fa``, 70 bases a line.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.harness.inputs import Inputs, fasta_bytes, generator, substituted, write_file


def make(cfg: dict, seed: int, workdir, device) -> Inputs:
    length = cfg["genome_bp"]
    per_clade = cfg["n_genomes"] // cfg["n_clades"]
    rates = np.geomspace(cfg["min_rate"], cfg["max_rate"], per_clade).tolist()
    folder = workdir / "genomes"
    folder.mkdir()
    paths = []
    for c in range(cfg["n_clades"]):
        ancestor = torch.randint(0, 4, (length,), generator=generator(device, seed, f"ancestor/{c}"),
                                 device=device, dtype=torch.uint8)
        for j, rate in enumerate(rates):
            g = substituted(ancestor, rate, generator(device, seed, f"genome/{c}/{j}"))
            path = folder / f"clade{c}_g{j}.fa"
            write_file(path, fasta_bytes(path.stem, g))
            paths.append(path)
    return Inputs(genome_paths=paths, bases=len(paths) * length)
