"""K1: canonical key extraction from the wire format (``csrc/extract.cu``).

Replaces ``orion_kmer_tpu/ops/kmers_pallas.py::_kernel``.  The plain
version is ``kmers_lanes.extract_canonical_lanes``.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..keys import SENTINEL_KEY
from .kmers_lanes import extract_canonical_lanes

launches = 0  # kernel launches since the last reset


def extract_keys_plain(lanes, invalid_words, k: int, n_positions: int):
    """Plain torch version of ``extract_keys``."""
    keys, valid = extract_canonical_lanes(lanes, invalid_words, k, n_positions)
    keys = torch.where(valid, keys, SENTINEL_KEY)
    return keys, valid.sum()


def extract_keys(lanes, invalid_words, k: int, n_positions: int):
    """Canonical keys of every position of a packed batch.

    lanes: int32[W] (u32 bits, 16 bases each); invalid_words: int32[W/2];
    n_positions: real position count (windows must end inside it).
    Returns (keys, n_valid): flipped int64 keys in position order,
    SENTINEL_KEY where the window is invalid, and the valid count as a
    0-d int64 tensor on the same device."""
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in 1..32, got {k}")
    W = lanes.shape[0]
    if lanes.dtype != torch.int32 or invalid_words.dtype != torch.int32:
        raise TypeError("extract_keys: lanes and invalid_words must be int32")
    if W % 2 or invalid_words.shape[0] != W // 2:
        raise ValueError(f"extract_keys: {W} lanes need {W // 2} invalid words")
    if lanes.device.type == "cpu":
        return extract_keys_plain(lanes, invalid_words, k, n_positions)
    _kernels.require_cuda("extract_keys", lanes, invalid_words)
    global launches
    lib = _kernels.lib()
    keys = torch.empty(16 * W, dtype=torch.int64, device=lanes.device)
    with _kernels.on_device(lanes):  # the grid follows this card's SM count
        block_valid = torch.empty(
            lib.okt_extract_blocks(W), dtype=torch.int32, device=lanes.device
        )
        _kernels.check(
            lib.okt_extract(
                lanes.data_ptr(), invalid_words.data_ptr(), W, k, n_positions,
                keys.data_ptr(), block_valid.data_ptr(), _kernels.stream_ptr(lanes),
            ),
            "extract_keys",
        )
    launches += 1
    return keys, block_valid.sum(dtype=torch.int64)
