"""K-mer database model + persistence.

In-memory model mirrors the reference ``KmerDbV2`` (db_types.rs:8-14):
``k`` plus a mapping reference-name -> set of unique canonical k-mers.
Here each set is a *sorted* numpy uint64 array -- sorted-unique arrays
are the native layout for the set joins (ops/setops.py)
and make serialization deterministic (a superset of the reference's
guarantee, whose Rust HashSet iteration order is arbitrary).

The port's own copy of ``orion_kmer_tpu/db.py``, with one change: sets
are made unique by a stable sort instead of ``np.unique``, which numpy
2.3.5 computes by hashing, many times slower on these sets: they arrive
as sorted runs (count tables, DB files, their concatenations), which
the stable sort (timsort) merges in linear time.

On disk the default format is bit-compatible with the reference: bincode
1.3 default config (fixed-int little-endian) serialization of
``KmerDbV2 { k: u8, references: HashMap<String, HashSet<u64>> }``
(build.rs:141, utils.rs:37-55), optionally wrapped in gz/xz/zst chosen by
output extension.  Databases written by the Rust binary load here and
vice versa.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .errors import ContextError, DeserializationError
from .ingest.compress import open_output, read_bytes

_U64 = struct.Struct("<Q")


def sorted_unique(values) -> np.ndarray:
    """``np.unique`` of u64 values, by a stable sort."""
    a = np.sort(np.asarray(values, dtype=np.uint64), kind="stable")
    if a.shape[0] < 2:
        return a
    keep = np.empty(a.shape[0], dtype=bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a if keep.all() else a[keep]


@dataclass
class KmerDb:
    k: int
    # reference name -> sorted unique uint64 canonical k-mers
    references: dict[str, np.ndarray] = field(default_factory=dict)

    def add_reference(self, name: str, kmers: np.ndarray) -> None:
        """Insert/overwrite a reference (db_types.rs:38-40)."""
        self.references[name] = sorted_unique(kmers)

    def get_all_kmers_unified(self) -> np.ndarray:
        """Union of all reference sets, sorted (db_types.rs:43-48)."""
        if not self.references:
            return np.empty(0, dtype=np.uint64)
        return sorted_unique(np.concatenate(list(self.references.values())))

    def total_unique_kmers(self) -> int:
        return int(self.get_all_kmers_unified().shape[0])

    def num_references(self) -> int:
        return len(self.references)

    # ---- bincode-compatible persistence -------------------------------

    def to_bincode(self) -> bytes:
        out = bytearray()
        out += struct.pack("<B", self.k)
        out += _U64.pack(len(self.references))
        for name, kmers in self.references.items():
            nb = name.encode("utf-8")
            out += _U64.pack(len(nb))
            out += nb
            out += _U64.pack(len(kmers))
            out += np.ascontiguousarray(kmers, dtype="<u8").tobytes()
        return bytes(out)

    @classmethod
    def from_bincode(cls, data: bytes, source: str = "<bytes>") -> "KmerDb":
        try:
            off = 0
            (k,) = struct.unpack_from("<B", data, off)
            off += 1
            (n_refs,) = _U64.unpack_from(data, off)
            off += 8
            if n_refs > len(data):  # cheap sanity bound
                raise ValueError(f"implausible reference count {n_refs}")
            refs: dict[str, np.ndarray] = {}
            for _ in range(n_refs):
                (name_len,) = _U64.unpack_from(data, off)
                off += 8
                name = data[off : off + name_len].decode("utf-8")
                if len(name.encode("utf-8")) != name_len:
                    raise ValueError("truncated reference name")
                off += name_len
                (n_kmers,) = _U64.unpack_from(data, off)
                off += 8
                nbytes = n_kmers * 8
                if off + nbytes > len(data):
                    raise ValueError("truncated k-mer set")
                arr = np.frombuffer(data, dtype="<u8", count=n_kmers, offset=off).astype(
                    np.uint64
                )
                off += nbytes
                refs[name] = sorted_unique(arr)
            if off != len(data):
                raise ValueError(f"{len(data) - off} trailing bytes")
            return cls(k=k, references=refs)
        except (struct.error, ValueError, UnicodeDecodeError) as e:
            raise DeserializationError(
                f"Failed to deserialize KmerDbV2 from {source!r}: {e}"
            ) from e

    def save(self, path) -> None:
        with open_output(path) as f:
            f.write(self.to_bincode())

    @classmethod
    def load(cls, path) -> "KmerDb":
        """Load a DB file, decompressing by extension (utils.rs:37-55)."""
        try:
            data = read_bytes(path)
        except ContextError as e:
            raise ContextError(
                f"Failed to get input reader for k-mer database: {str(path)!r}", e
            ) from e
        return cls.from_bincode(data, source=str(path))
