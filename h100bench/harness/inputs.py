"""Helpers of the input generators: seeded streams on the device, FASTA
rendered on the device, file writes behind the generation, and a run's
scratch space."""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

FASTA_WIDTH = 70
BASES_N = b"ACGTN"


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each named stream of a run's seed, so
    one stream's draws do not depend on another's."""
    return int.from_bytes(hashlib.sha256(f"{seed}/{tag}".encode()).digest()[:8], "little") >> 1


def generator(device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def substituted(codes: torch.Tensor, rate: float, g: torch.Generator) -> torch.Tensor:
    """``codes`` with each base replaced, at ``rate``, by one of the
    other three."""
    subs = torch.rand(codes.shape, generator=g, device=codes.device) < rate
    shift = torch.randint(1, 4, codes.shape, generator=g, device=codes.device, dtype=torch.uint8)
    return torch.where(subs, (codes + shift) % 4, codes)


def fasta_bytes(name: str, codes: torch.Tensor) -> np.ndarray:
    """One FASTA record of 2-bit codes (4 = N), 70 bases a line, rendered
    on the codes' device; the bytes as a host array."""
    n = codes.shape[0]
    dev = codes.device
    lut = torch.tensor(list(BASES_N), dtype=torch.uint8, device=dev)
    lines = -(-n // FASTA_WIDTH)
    body = torch.full((n + lines,), ord("\n"), dtype=torch.uint8, device=dev)
    at = torch.arange(n, device=dev)
    body[at + at // FASTA_WIDTH] = lut[codes.long()]
    head = np.frombuffer(f">{name}\n".encode(), np.uint8)
    return np.concatenate([head, body.cpu().numpy()])


class Writer:
    """Writes arrays to one file on a thread of its own, in order, so the
    next block is generated while the last is written."""

    def __init__(self, path):
        self._f = open(path, "wb")
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="h100bench-write")
        self._pending = []

    def write(self, arr: np.ndarray) -> None:
        while len(self._pending) >= 2 or (self._pending and self._pending[0].done()):
            self._pending.pop(0).result()
        self._pending.append(self._pool.submit(self._f.write, memoryview(arr).cast("B")))

    def close(self) -> None:
        for p in self._pending:
            p.result()
        self._pool.shutdown(wait=True)
        self._f.close()


class Workdir:
    """A run's scratch: a directory under ``TMPDIR`` (``workdir / name``
    is a path in it) and files in this process's memory alone
    (``memory_file``).  ``close`` removes both."""

    def __init__(self, base=None):
        self.path = Path(tempfile.mkdtemp(prefix="h100bench-", dir=base))
        self._fds: list[int] = []

    def __truediv__(self, name: str) -> Path:
        return self.path / name

    def __fspath__(self) -> str:
        return str(self.path)

    def memory_file(self, name: str) -> Path:
        """A file held in memory (``memfd``), as a path that ``open``
        reads like any file: an input read many times is never written to
        disk."""
        fd = os.memfd_create(name)
        self._fds.append(fd)
        return Path(f"/proc/{os.getpid()}/fd/{fd}")

    def close(self) -> None:
        while self._fds:
            os.close(self._fds.pop())
        shutil.rmtree(self.path, ignore_errors=True)


def write_file(path, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(memoryview(arr).cast("B"))


Inputs = SimpleNamespace
