"""orion-kmer-tpu-torch: the PyTorch / CUDA port of ``orion_kmer_tpu``.

Exact canonical k-mer counting (``count``) and database building
(``build``) on one NVIDIA H100, with the same outputs, byte for byte, as
the JAX package, which stays beside it as the reference.

Layer map (bottom-up), each module named after its JAX counterpart:
  keys         -- int64 key representation (u64 XOR 2^63) and conversions
  host         -- host batching: native parse, halos, wire packing, the
                  prefetch thread and the host count accumulator
  ops          -- extraction (K1), run merge (K2), compaction (K3) and the
                  count pipeline built from them; csrc/ holds the kernels
  engine       -- DeviceCountTable (LSM merge forest + device table) and
                  count_file / unique_from_file
  commands,cli -- the ``count`` and ``build`` subcommands

Host-only modules of the JAX package (codec, db, errors, ingest, utils)
are imported as they are; nothing here imports jax.
"""

from orion_kmer_tpu.version import __version__

__all__ = ["__version__"]
