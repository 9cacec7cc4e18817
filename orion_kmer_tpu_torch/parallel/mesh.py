"""The shard list: which device each shard of a sharded count sits on.

The torch counterpart of ``orion_kmer_tpu/parallel/mesh.py``.  The JAX
package builds a one-axis ``Mesh`` for ``shard_map``; the port loops over
its shards in Python, each under its own device, so a mesh is a plain
list of ``torch.device``, one entry per shard.  The shard axis is both
the data axis (a batch is cut into one block per shard) and the table
axis (the 64-bit key space is hash-range-partitioned over the shards).
A shard is logical: several may share one device.
"""

from __future__ import annotations

import torch


def make_mesh(n_shards: int | None = None, devices=None) -> list[torch.device]:
    """One device per shard.

    devices: a device or a list of devices; by default every visible CUDA
    card (an error when there is none: ask for the CPU with
    ``devices="cpu"``).  n_shards: by default one shard per device; more
    shards than devices go round-robin over them, fewer take the first
    ones."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA device is visible (pass devices="cpu" for CPU shards)')
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    if n_shards is None:
        n_shards = len(devices)
    if n_shards < 1:
        raise ValueError(f"make_mesh: n_shards must be positive, got {n_shards}")
    return [devices[s % len(devices)] for s in range(n_shards)]
