"""The on-disk layout of the upstream orion-kmer ``KmerDbV2``, frozen here.

bincode 1.3 with its default configuration (fixed-width little-endian
integers) of ``KmerDbV2 { k: u8, references: HashMap<String,
HashSet<u64>> }``: the u8 k; a u64 count of references; per reference a
u64 byte length, the UTF-8 name, a u64 count of k-mers and the k-mers,
each a u64.  The benchmark writes the query cell's database in this layout
from the reference's own k-mer sets.
"""

from __future__ import annotations

import struct

import numpy as np

_U64 = struct.Struct("<Q")


def write_db(path, k: int, refs: dict[str, np.ndarray]) -> int:
    """Write ``refs`` (name -> sorted unique u64 k-mers) as a KmerDbV2
    file; returns its size in bytes."""
    size = 0
    with open(path, "wb") as f:
        head = struct.pack("<B", k) + _U64.pack(len(refs))
        f.write(head)
        size += len(head)
        for name, kmers in refs.items():
            nb = name.encode("utf-8")
            part = _U64.pack(len(nb)) + nb + _U64.pack(kmers.shape[0])
            f.write(part)
            body = np.ascontiguousarray(kmers, dtype="<u8")
            f.write(memoryview(body).cast("B"))
            size += len(part) + body.nbytes
    return size
