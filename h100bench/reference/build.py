"""Plain reference of ``build -k K -g <genomes>``: each genome's set of
canonical k-mers, ascending, under the file's base name, as what the
database holds (name -> (k-mers, tree digest of their u64 bytes)).  The
control keys each set by a 40-bit hash, as an approximate set would."""

from __future__ import annotations

import os

import torch

from ..harness.digest import tree_digest
from . import kmers


def genome_set(path, k: int, device) -> torch.Tensor:
    codes = torch.from_numpy(kmers.fasta_codes(path, normalize=True)).to(device)
    keys, valid = kmers.window_keys(codes[None, :], k)
    return torch.unique(keys[valid], sorted=True)


def _db(paths, k, device, pool, narrow: bool) -> dict:
    refs = {}
    for path in paths:
        s = genome_set(path, k, device)
        if narrow:
            s, _ = kmers.narrowed(s, torch.ones_like(s))
        host = s.cpu().numpy()
        refs[os.path.basename(os.fspath(path))] = (int(host.shape[0]), tree_digest(host, pool))
    return {"k": k, "refs": refs}


def expected(paths, k: int, device, pool) -> dict:
    return _db(paths, k, device, pool, narrow=False)


def control(paths, k: int, device, pool) -> dict:
    return _db(paths, k, device, pool, narrow=True)
