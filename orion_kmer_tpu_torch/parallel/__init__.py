"""Counting spread over several shards (devices): the torch counterpart of
``orion_kmer_tpu/parallel``."""

from .mesh import make_mesh
from .sharded import sharded_count
from .streaming import ShardedCountTable

__all__ = ["make_mesh", "sharded_count", "ShardedCountTable"]
