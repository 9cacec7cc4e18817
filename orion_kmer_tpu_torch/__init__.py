"""orion-kmer-tpu-torch: the PyTorch / CUDA port of ``orion_kmer_tpu``.

Exact canonical k-mer counting (``count``), database building
(``build``) and the set joins (``compare``, ``query``, ``classify``) on
one NVIDIA H100, with the same outputs, byte for byte, as the JAX
package, which stays beside it as the reference.

Layer map (bottom-up), each module named after its JAX counterpart:
  errors, version, codec, db, ingest, utils
               -- the port's own copies of the JAX package's host-only
                  modules (the C++ parser is ingest/fastx.cpp)
  keys         -- int64 key representation (u64 XOR 2^63) and conversions
  host         -- host batching: native parse, halos, wire packing, the
                  prefetch thread and the host count accumulator
  ops          -- extraction (K1), run merge (K2), compaction (K3), block
                  sort (K4), the count pipeline and the set joins built
                  from them; csrc/ holds the kernels
  engine       -- DeviceCountTable, count_file / unique_from_file, and the
                  join entries query_file, ClassifyJoiner and
                  intersection_size_host
  commands,cli -- the subcommands; ``--device`` (default cuda) picks the
                  device

Nothing here imports jax or the JAX package.
"""

from .version import __version__

__all__ = ["__version__"]
