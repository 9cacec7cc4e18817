"""Published peaks of the card, and the least bytes each kernel's work
needs.

NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): 3.35 TB/s of
HBM3 bandwidth.  A roofline share is the least time the card could take,
bytes over that bandwidth, divided by the kernel's measured device time.
The k-mer kernels do integer work only, so no FLOP peak bounds them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def k1_bytes(bases: int, valid_windows: int) -> int:
    """The least bytes K1 (canonical k-mer extraction) moves for an input:
    every base read once at 2 bits, and every valid window's 8-byte key
    written once, whatever the kernel reads again or writes besides."""
    return bases // 4 + (bases % 4 > 0) + 8 * valid_windows


def roofline_pct(n_bytes: float, device_s: float) -> float | None:
    """Percent of the bandwidth bound that ``device_s`` of kernel time
    reached; None without a measured time."""
    if device_s <= 0:
        return None
    return 100.0 * (n_bytes / HBM_BYTES_PER_S) / device_s
