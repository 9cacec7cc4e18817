"""The premise of the radix sort's narrowed bit range, on the CPU: K1's
canonical keys differ only in their low 2k bits, so a radix sort of those
bits (modelled here in numpy, digit by digit, at the kernel's width) orders them, sentinels included, exactly as a sort of all 64 does.
The kernel itself is held against ``torch.sort`` on a card
(``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from orion_kmer_tpu_torch import codec
from orion_kmer_tpu_torch.host import pack_for_transfer
from orion_kmer_tpu_torch.keys import SENTINEL_KEY, SIGN
from orion_kmer_tpu_torch.ops import extract, radix

READ_LEN = 300


def _reads(rng) -> dict[str, bytes]:
    random = rng.choice(list(b"ACGT"), size=READ_LEN).astype(np.uint8)
    broken = random.copy()
    for start in rng.integers(0, READ_LEN - 8, 6):  # N runs of 1 to 8 bases
        broken[start : start + rng.integers(1, 9)] = ord("N")
    return {
        "random": random.tobytes(),
        "all A": b"A" * READ_LEN,
        "all T": b"T" * READ_LEN,
        "palindromic": (b"ACGT" * READ_LEN)[:READ_LEN],  # ACGT is its own reverse complement
        "N-broken": broken.tobytes(),
    }


def _canonical_keys(read: bytes, k: int) -> np.ndarray:
    """The plain extractor's keys of one read, in a batch longer than the
    read, so its tail is sentinels too."""
    lanes, inv = pack_for_transfer(codec.seq_to_codes(read), 512)
    keys, _ = extract.extract_keys_plain(
        torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(inv.view(np.int32)), k, len(read)
    )
    return keys.numpy()


def _lsd_model(keys: np.ndarray, key_bits: int, bits: int) -> np.ndarray:
    """What csrc/radix.cu computes: bit 63 flipped, then a stable sort by
    each digit of bits [0, key_bits), lowest first."""
    u = keys.view(np.uint64) ^ SIGN
    for shift in range(0, key_bits, bits):
        width = min(bits, key_bits - shift)
        digit = (u >> np.uint64(shift)) & np.uint64((1 << width) - 1)
        u = u[np.argsort(digit, kind="stable")]
    return (u ^ SIGN).view(np.int64)


@pytest.mark.parametrize("k", range(1, 33))
def test_canonical_keys_differ_only_in_their_low_2k_bits(k):
    rng = np.random.default_rng(k)
    key_bits = 2 * k
    low = (1 << key_bits) - 1
    batch = []
    for name, read in _reads(rng).items():
        keys = _canonical_keys(read, k)
        real = keys != SENTINEL_KEY
        assert real.any() and (~real).any(), name  # every batch has windows and sentinels
        u = keys[real].view(np.uint64) ^ SIGN
        if key_bits < 64:
            assert not (u >> np.uint64(key_bits)).any(), name
        assert not (u & np.uint64(low) == np.uint64(low)).any(), name
        batch.append(keys)
    keys = np.concatenate(batch)
    want = np.sort(keys)
    assert np.array_equal(_lsd_model(keys, key_bits, radix._DIGIT_BITS), want)
    assert torch.equal(radix.sort_keys(torch.from_numpy(keys), key_bits), torch.from_numpy(want))


def test_the_model_needs_the_premise():
    """The model is no tautology: keys that differ above the bit range
    come out of it unsorted."""
    keys = np.array([5 << 40, 1 << 40, 7], dtype=np.int64)
    assert not np.array_equal(_lsd_model(keys, 40, radix._DIGIT_BITS), np.sort(keys))
    assert np.array_equal(_lsd_model(keys, 64, radix._DIGIT_BITS), np.sort(keys))


@pytest.mark.parametrize(
    "key_bits,n_passes",
    # one pass a 9-bit digit, the last one short: 7 for the 62 bits of k = 31
    [(2, 1), (8, 1), (9, 1), (16, 2), (18, 2), (32, 4), (42, 5), (48, 6), (62, 7), (64, 8)],
)
def test_passes_follow_the_bit_range(key_bits, n_passes):
    """The pass count decides which of the two buffers holds the result."""
    assert radix.passes(key_bits) == n_passes
    assert (n_passes - 1) * radix._DIGIT_BITS < key_bits <= n_passes * radix._DIGIT_BITS


def test_sort_keys_checks_its_arguments():
    x = torch.arange(5, dtype=torch.int64)
    with pytest.raises(TypeError):
        radix.sort_keys(x.to(torch.int32))
    with pytest.raises(TypeError):
        radix.sort_keys(x.reshape(1, 5))
    for key_bits in (0, 65):
        with pytest.raises(ValueError):
            radix.sort_keys(x, key_bits)
    meta = torch.empty(5, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):  # neither a CPU tensor nor a card's
        radix.sort_keys(meta, 62)
