"""BOC/CBOC subcarrier modulation (waveform/gnss/boc.rs re-design)."""

from __future__ import annotations

import numpy as np

# CBOC: E1B = (1/sqrt(11))·(3·BOC(1,1) - ... ) per Galileo OS ICD
CBOC_ALPHA = np.sqrt(10.0 / 11.0)  # BOC(1,1) weight
CBOC_BETA = np.sqrt(1.0 / 11.0)  # BOC(6,1) weight


def boc_subcarrier(m: int, n: int, n_samples_per_chip: int) -> np.ndarray:
    """One chip of the BOC(m,n) square subcarrier, sampled.

    BOC(m,n): subcarrier frequency m×1.023 MHz on an n×1.023 Mcps code →
    2m/n half-cycles per chip (boc.rs:23-80).
    """
    half_cycles = 2 * m // n
    # integer segment arithmetic avoids sin() boundary roundoff
    seg = (np.arange(n_samples_per_chip) * half_cycles) // n_samples_per_chip
    return np.where(seg % 2 == 0, 1.0, -1.0).astype(np.float32)


def boc_spread(chips: np.ndarray, m: int, n: int,
               samples_per_chip: int) -> np.ndarray:
    """Spread ±1 chips with the BOC subcarrier → (len(chips)*spc,)."""
    sub = boc_subcarrier(m, n, samples_per_chip)
    return (np.repeat(chips.astype(np.float32), samples_per_chip)
            * np.tile(sub, len(chips)))


def cboc_spread(chips: np.ndarray, samples_per_chip: int,
                pilot: bool = True) -> np.ndarray:
    """CBOC(6,1,1/11) spreading for Galileo E1 (boc.rs:90-142).

    E1B (data): α·BOC(1,1) + β·BOC(6,1); E1C (pilot): α·BOC(1,1) −
    β·BOC(6,1).
    """
    b11 = boc_spread(chips, 1, 1, samples_per_chip)
    b61 = boc_spread(chips, 6, 1, samples_per_chip)
    sign = -1.0 if pilot else 1.0
    return (CBOC_ALPHA * b11 + sign * CBOC_BETA * b61).astype(np.float32)


def boc_psd(f: np.ndarray, m: int, n: int, fc: float = 1.023e6) -> np.ndarray:
    """Normalized BOC(m,n) power spectral density (boc.rs PSD), for
    even 2m/n: PSD ∝ (tan(πf/2fs)·sin(πf/fc) / (πf))²."""
    fs = m * fc
    fchip = n * fc
    f = np.asarray(f, np.float64)
    eps = 1e-9
    num = np.tan(np.pi * f / (2 * fs) + eps) * np.sin(np.pi * f / fchip)
    psd = fchip * (num / (np.pi * np.maximum(np.abs(f), eps))) ** 2
    return psd / psd.max()
