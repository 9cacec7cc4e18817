"""orion-kmer-tpu-torch: the PyTorch / CUDA port of ``orion_kmer_tpu``.

Every subcommand of the JAX package's CLI on one NVIDIA H100: exact
canonical k-mer counting (``count``), database building (``build``), the
set joins (``compare``, ``query``, ``classify``), FracMinHash sketches
(``sketch``, ``sketch-compare``), multi-sample profiles (``profile``),
the resident server (``serve``, ``--server``) and the cohort metadata
tools (``cohort``), with the same outputs, byte for byte, as the JAX
package, which stays beside it as the reference; ``count`` and
``build`` also spread over several devices and processes
(``parallel/``).

Layer map (bottom-up), each module named after its JAX counterpart
where it has one.  A module imports only from its own line or the lines
below it, but for the CLI's import of the server, which runs the CLI
(``tests/test_torch_layers.py`` holds the graph to that one cycle):
  errors, version, codec, ingest, utils, cohort
               -- the port's own copies of the JAX package's host-only
                  modules (the C++ parser is ingest/fastx.cpp)
  keys         -- int64 key representation (u64 XOR 2^63) and conversions
  host         -- host batching: native parse, halos, wire packing, the
                  prefetch thread and the host count accumulator
  staging      -- the host <-> device link: the pinned ring that stages
                  count and query batches, ``to_device``, ``to_host`` and
                  the count table's fetch
  ops          -- extraction (K1), run merge (K2), compaction (K3), block
                  sort (K4), the hashes, the count pipeline, the batch
                  sketch and the set joins and union built from them;
                  csrc/ holds the kernels, _kernels builds and loads them
  table        -- DeviceCountTable, the device-resident count table
  db           -- the k-mer database model and its bincode files; a
                  card's union through ``ops.setops``
  parallel     -- the count spread over several shards and processes
  engine       -- count_file / unique_from_file (one table or sharded),
                  and the join entries query_file, ClassifyJoiner and
                  intersection_size_host
  commands,cli -- the subcommands; ``--device`` (default cuda) picks the
                  device
  server       -- ``serve`` and the ``--server`` client

Nothing here imports jax or the JAX package.
"""

from .version import __version__

__all__ = ["__version__"]
