"""Host-side 2-bit DNA codec (numpy, vectorized).

Semantics are bit-exact with the reference codec (orion-kmer/src/kmer.rs):

  * A=00, C=01, G=10, T=11; case-insensitive (kmer.rs:12-20)
  * k-mers pack MSB-first into a u64: the first base occupies the most
    significant used bits (kmer.rs:37-57)
  * any non-ACGT byte invalidates the whole k-mer window (kmer.rs:53)
  * reverse complement = per-base XOR 0b11 + positional reversal
    (kmer.rs:79-94)
  * canonical = min(kmer, rc) as unsigned integer compare, which equals
    lexicographic string order because the encoding is order-preserving
    and MSB-aligned (kmer.rs:99-106)

The port's own copy of ``orion_kmer_tpu/codec.py``: the *semantic
oracle* for the port's kernels (``chip_smoke.py`` checks the card's
output against it) and the string encode/decode path for CLI output.
"""

from __future__ import annotations

import numpy as np

from .errors import validate_k

# Byte -> 2-bit code lookup. 255 marks invalid (non-ACGT) bytes.
INVALID_CODE = np.uint8(255)
_BASE_LUT = np.full(256, INVALID_CODE, dtype=np.uint8)
for _b, _v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    _BASE_LUT[_b[0]] = _v
    _BASE_LUT[_b[1]] = _v

# 2-bit code -> ASCII base (kmer.rs:24-32)
_CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)

# needletail-style normalization LUT (Sequence::normalize(false)):
# uppercase; u/U -> T; everything not ACGT -> invalid.  Used by count /
# build / classify (count.rs:71, build.rs:48, classify.rs:165).  The
# `query` command deliberately skips normalization and uses raw read
# bytes (query.rs:80-81), where 'U' is NOT a valid base.
_NORM_LUT = np.full(256, INVALID_CODE, dtype=np.uint8)
_NORM_LUT[:] = _BASE_LUT
for _u in b"Uu":
    _NORM_LUT[_u] = 3  # U -> T


def seq_to_codes(seq: bytes | np.ndarray, normalize: bool = True) -> np.ndarray:
    """Map ASCII sequence bytes to 2-bit codes (255 = invalid base)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray, memoryview)) else np.asarray(seq, dtype=np.uint8)
    lut = _NORM_LUT if normalize else _BASE_LUT
    return lut[arr]


def seq_to_u64(seq: bytes, k: int) -> int | None:
    """Encode one k-length sequence into a u64; None on invalid (kmer.rs:37-57)."""
    if k < 1 or k > 32 or len(seq) != k:
        return None
    codes = seq_to_codes(seq, normalize=False)
    if (codes == INVALID_CODE).any():
        return None
    val = 0
    for c in codes.tolist():
        val = (val << 2) | c
    return val


def u64_to_seq(val: int, k: int) -> bytes:
    """Decode a u64 k-mer back to ASCII (kmer.rs:61-75)."""
    validate_k(k)
    out = bytearray(k)
    for i in range(k):
        out[k - 1 - i] = _CODE_TO_BASE[(val >> (2 * i)) & 0b11]
    return bytes(out)


def u64s_to_seqs(vals: np.ndarray, k: int) -> list[bytes]:
    """Vectorized decode of many u64 k-mers to ASCII byte strings."""
    validate_k(k)
    vals = np.asarray(vals, dtype=np.uint64)
    n = vals.shape[0]
    if n == 0:
        return []
    shifts = (2 * (k - 1 - np.arange(k, dtype=np.uint64))).astype(np.uint64)
    codes = (vals[:, None] >> shifts[None, :]) & np.uint64(3)
    chars = _CODE_TO_BASE[codes.astype(np.uint8)]
    flat = chars.tobytes()
    return [flat[i * k : (i + 1) * k] for i in range(n)]


def reverse_complement_u64(vals: np.ndarray | int, k: int) -> np.ndarray | int:
    """Vectorized reverse complement on packed u64 k-mers (kmer.rs:79-94)."""
    validate_k(k)
    scalar = np.isscalar(vals) or isinstance(vals, int)
    v = np.asarray(vals, dtype=np.uint64)
    # Complement every 2-bit group (XOR with all-ones), then reverse
    # 2-bit groups within the 64-bit word, then right-align to 2k bits.
    x = ~v
    x = ((x & np.uint64(0x3333333333333333)) << np.uint64(2)) | (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333)
    )
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | (
        (x >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
    )
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | (
        (x >> np.uint64(8)) & np.uint64(0x00FF00FF00FF00FF)
    )
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | (
        (x >> np.uint64(16)) & np.uint64(0x0000FFFF0000FFFF)
    )
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    x = x >> np.uint64(64 - 2 * k)
    return int(x) if scalar else x


def canonical_u64(vals: np.ndarray | int, k: int) -> np.ndarray | int:
    """Canonical k-mer = min(kmer, rc) as u64 compare (kmer.rs:99-106)."""
    scalar = np.isscalar(vals) or isinstance(vals, int)
    v = np.asarray(vals, dtype=np.uint64)
    rc = reverse_complement_u64(v, k)
    out = np.minimum(v, rc)
    return int(out) if scalar else out


def extract_kmers_np(codes: np.ndarray, k: int, canonical: bool = True) -> np.ndarray:
    """Extract all valid k-mer windows from a code array (numpy path).

    ``codes`` is uint8 with 255 marking invalid bases.  Windows containing
    an invalid base are skipped whole; arrays shorter than k yield nothing
    (count.rs:23-38 semantics, step-1 sliding window).

    Returns a uint64 array of (canonical) k-mers, one per valid window,
    in sequence order.
    """
    validate_k(k)
    n = codes.shape[0]
    if n < k:
        return np.empty(0, dtype=np.uint64)
    invalid = codes == INVALID_CODE
    c64 = np.where(invalid, 0, codes).astype(np.uint64)
    # Rolling pack via per-offset shifts: kmer[i] = sum_j codes[i+j] << 2(k-1-j)
    nwin = n - k + 1
    vals = np.zeros(nwin, dtype=np.uint64)
    for j in range(k):
        vals = (vals << np.uint64(2)) | c64[j : j + nwin]
    # window validity via prefix sums of the invalid mask
    bad = np.cumsum(invalid.astype(np.int64))
    bad = np.concatenate([[0], bad])
    ok = (bad[k:] - bad[:-k]) == 0
    vals = vals[ok]
    if canonical:
        vals = canonical_u64(vals, k)
    return vals
