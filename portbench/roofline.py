"""Peaks of the card and the work of the steps whose roofline share the
benchmark reports.

The peaks are NVIDIA's data sheet for the H100 SXM at its full power limit
of 700 W, dense rates; the result line's stderr gives the card's own limit.
Each count is of the work the step has to do, whatever implements it, so a
share reads the same for a fused kernel and for a chain of library calls.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM, FP32 outside the tensor cores


def demod_bytes(rows: int, k: int) -> int:
    """Device-memory bytes of the demodulation step on `rows` rows of K chips:
    the complex64 IQ read once (rows·K·8), the complex64 downchirp once
    (K·8), and the int32 symbol, float32 SNR and float32 magnitude of each
    row written once (rows·12)."""
    return rows * k * 8 + k * 8 + rows * 12


def demod_flops(rows: int, k: int) -> int:
    """Operations of the demodulation step: per point, the dechirp's complex
    product (6), a radix-2 FFT's 5·log2(K), and |X|² with its share of the
    argmax, peak and mean (3): rows·K·(6 + 5·log2 K + 3)."""
    return rows * k * (6 + 5 * int(math.log2(k)) + 3)


def least_seconds(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take for the work, and what bounds it:
    the larger of bytes over the HBM rate and operations over the FP32 rate."""
    by_bytes, by_flops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops, "flops")


def demod_share(rows: int, k: int, seconds: float) -> float:
    """The demodulation step's share of its roofline, in %: least time over
    the measured time of the call on these rows."""
    least, _ = least_seconds(demod_bytes(rows, k), demod_flops(rows, k))
    return 100.0 * least / seconds
