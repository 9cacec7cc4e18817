"""Lane-parallel canonical k-mer extraction, plain PyTorch version.

The torch counterpart of ``orion_kmer_tpu/ops/kmers_lanes.py``
(``extract_canonical_lane_math`` and ``extract_canonical_lanes``) and of
the two bit helpers of ``orion_kmer_tpu/ops/kmers.py``.  It is the plain
version of kernel K1 (``csrc/extract.cu``): the CPU path, and what the
kernel is held against on the card.

The wire format packs 16 bases per u32 lane, LSB-first.  For each of the
16 intra-lane offsets a window's 2k bits are assembled from lanes
(w, w+1, w+2); the LSB-first window complemented is the reverse
complement, and its 2-bit-group reversal is the forward k-mer.

torch has no uint32 arithmetic and its ``>>`` on int32 is arithmetic, so
every u32 value here lives in an int64 in [0, 2^32), and left shifts mask
first so nothing leaves that range.  Lanes past the end read as zero
bases flagged invalid (the JAX version wraps with ``jnp.roll`` and relies
on the position bound instead).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_MASK2 = 0x33333333
_MASK4 = 0x0F0F0F0F
_MASK8 = 0x00FF00FF
_MASK16 = 0x0000FFFF


def _shl(x: torch.Tensor, s: int) -> torch.Tensor:
    """(x << s) & 0xFFFFFFFF for x in [0, 2^32), without leaving the range."""
    return (x & ((1 << (32 - s)) - 1)) << s


def _reverse_2bit_groups_32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups within each u32 value."""
    x = ((x & _MASK2) << 2) | ((x >> 2) & _MASK2)
    x = ((x & _MASK4) << 4) | ((x >> 4) & _MASK4)
    x = ((x & _MASK8) << 8) | ((x >> 8) & _MASK8)
    x = ((x & _MASK16) << 16) | ((x >> 16) & _MASK16)
    return x


def _shift_right_u64(hi: torch.Tensor, lo: torch.Tensor, s: int):
    """Logical right shift of the (hi, lo) 64-bit pair by static s."""
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, (lo >> s) | _shl(hi, 32 - s)
    if s == 32:
        return torch.zeros_like(hi), hi
    return torch.zeros_like(hi), hi >> (s - 32)


def lane_masks_from_invalid_words(invalid_words: torch.Tensor) -> torch.Tensor:
    """u32 invalid bitmap (32 flags/word) -> per-lane 16-bit masks."""
    w = invalid_words.to(torch.int64) & M32
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(-1)


def extract_canonical_lane_math(A, B, C, MA, MB, MC, k: int):
    """Per-lane math: A/B/C are lanes w, w+1, w+2 and MA/MB/MC their
    16-bit invalid masks, all int64 in [0, 2^32).  Returns (hi, lo,
    window_ok), each shaped (W, 16): lane-major, so position
    p = 16 * lane + offset sits at flat index p."""
    mask2k_hi = ((1 << (2 * k)) - 1) >> 32
    mask2k_lo = ((1 << (2 * k)) - 1) & M32
    maskk = (1 << k) - 1

    outs_hi, outs_lo, outs_ok = [], [], []
    for o in range(16):
        if o == 0:
            w_lo, w_hi = A, B
            m = MA | (MB << 16)
        else:
            w_lo = (A >> (2 * o)) | _shl(B, 32 - 2 * o)
            w_hi = (B >> (2 * o)) | _shl(C, 32 - 2 * o)
            # invalid bits o..o+31 of the 48-bit (MA, MB, MC) triple
            m = (MA >> o) | (MB << (16 - o)) | (MC << (32 - o))
        # (w_hi, w_lo) holds bases o..o+31 LSB-first; window = low 2k bits;
        # rc (MSB-first) = complement of the LSB-first window
        if k <= 16:
            rc_hi = torch.zeros_like(w_hi)
            rc_lo = (~w_lo) & mask2k_lo
        else:
            rc_hi = (~w_hi) & mask2k_hi
            rc_lo = (~w_lo) & M32
        # fwd (MSB-first) = 2-bit-group reversal of the window
        f_hi = _reverse_2bit_groups_32(w_lo)
        f_lo = _reverse_2bit_groups_32(w_hi)
        f_hi, f_lo = _shift_right_u64(f_hi, f_lo, 64 - 2 * k)
        take_rc = (rc_hi < f_hi) | ((rc_hi == f_hi) & (rc_lo < f_lo))
        outs_hi.append(torch.where(take_rc, rc_hi, f_hi))
        outs_lo.append(torch.where(take_rc, rc_lo, f_lo))
        outs_ok.append((m & maskk) == 0)
    return (
        torch.stack(outs_hi, dim=1),
        torch.stack(outs_lo, dim=1),
        torch.stack(outs_ok, dim=1),
    )


def extract_canonical_lanes(lanes, invalid_words, k: int, n_positions: int):
    """Lane-parallel extraction over the packed wire format.

    lanes: int32[W] holding u32 bits; invalid_words: int32[W/2];
    n_positions: real (unpadded) position count -- windows must fit
    inside it.

    Returns (keys, valid), each of length 16 * W in position order:
    flipped int64 canonical keys (see ``keys.py``; arbitrary where not
    valid) and the window-valid mask.
    """
    W = lanes.shape[0]
    A = lanes.to(torch.int64) & M32
    zero = A.new_zeros(2)
    full = A.new_full((2,), 0xFFFF)  # lanes past the end: invalid bases
    B = torch.cat([A[1:], zero[:1]])
    C = torch.cat([A[2:], zero])[:W]
    M = lane_masks_from_invalid_words(invalid_words)
    MB = torch.cat([M[1:], full[:1]])
    MC = torch.cat([M[2:], full])[:W]
    hi, lo, ok = extract_canonical_lane_math(A, B, C, M, MB, MC, k)
    keys = ((hi ^ 0x80000000) << 32) | lo  # u64 ^ 2^63, wrapping into int64
    pos = torch.arange(16 * W, device=lanes.device)
    valid = ok.reshape(-1) & (pos <= n_positions - k)
    return keys.reshape(-1), valid
