"""Spreading-code generators: LFSR/m-sequence, Gold, Barker, Zadoff-Chu.

PyTorch counterpart of ``r4w_tpu.ops.spreading``: the code generators,
copied bit for bit. Codes are tiny and static, so they are numpy arrays
built once on the host; callers move them to a device as constants.
Chips use the BPSK mapping bit 0 -> +1, bit 1 -> -1. The RAKE receiver
(``rake_search``, ``rake_despread``, ``rake_combine``; rake_receiver.rs)
correlates clamped windows of the received samples with the code by FP32
products (no TF32); reads past the end clamp to the last sample, as the
reference's gather does, and ties in its peak picking take the first
delay.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import complex_abs
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor

# Preferred m-sequence polynomial pairs for Gold codes (lfsr.rs:157-165)
GOLD_PREFERRED_PAIRS = {
    5: (0x12, 0x1E),
    6: (0x21, 0x33),
    7: (0x41, 0x47),
    8: (0x8E, 0xAE),
    9: (0x108, 0x130),
    10: (0x204, 0x327),
}

# Default m-sequence polynomials by degree (lfsr.rs:113-124)
MSEQ_POLY = {
    3: 0x05, 4: 0x09, 5: 0x12, 6: 0x21, 7: 0x41, 8: 0x8E, 9: 0x108,
    10: 0x204,
}

# All known Barker codes (barker.rs:36-55)
BARKER_CODES = {
    2: [1, -1],
    3: [1, 1, -1],
    4: [1, 1, -1, 1],
    5: [1, 1, 1, -1, 1],
    7: [1, 1, 1, -1, -1, 1, -1],
    11: [1, 1, 1, -1, -1, -1, 1, -1, -1, 1, -1],
    13: [1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1],
}


def lfsr_bits(degree: int, polynomial: int, initial_state: int = 0x01,
              length: int | None = None) -> np.ndarray:
    """Fibonacci LFSR output bits: MSB out, feedback = parity(state & poly),
    shift left. `length` defaults to one period, 2^degree - 1."""
    n = length if length is not None else (1 << degree) - 1
    state = initial_state
    mask = (1 << degree) - 1
    out = np.empty(n, np.int8)
    for i in range(n):
        out[i] = (state >> (degree - 1)) & 1
        fb = bin(state & polynomial).count("1") & 1
        state = ((state << 1) | fb) & mask
    return out


def _bits_to_chips(bits: np.ndarray) -> np.ndarray:
    return np.where(bits == 0, 1, -1).astype(np.int8)


@functools.lru_cache(maxsize=None)
def m_sequence(degree: int, polynomial: int | None = None,
               initial_state: int = 0x01) -> np.ndarray:
    """Full-period m-sequence as ±1 chips, length 2^degree - 1."""
    poly = polynomial if polynomial is not None else MSEQ_POLY[degree]
    return _bits_to_chips(lfsr_bits(degree, poly, initial_state))


@functools.lru_cache(maxsize=None)
def gold_code(degree: int, index: int) -> np.ndarray:
    """Gold code family member as ±1 chips (gold.rs:131-163).

    index 0 -> m-seq A, 1 -> m-seq B, k>=2 -> A xor roll(B, -(k-2)).
    Family size 2^degree + 1.
    """
    poly_a, poly_b = GOLD_PREFERRED_PAIRS[degree]
    a = lfsr_bits(degree, poly_a)
    b = lfsr_bits(degree, poly_b)
    n = len(a)
    index = index % (n + 2)
    if index == 0:
        return _bits_to_chips(a)
    if index == 1:
        return _bits_to_chips(b)
    return _bits_to_chips(a ^ np.roll(b, -(index - 2)))


def gold_family(degree: int, count: int | None = None) -> np.ndarray:
    """(count, 2^degree - 1) bank of Gold codes — one constant array for
    batched correlation on the MXU."""
    n = (1 << degree) - 1
    count = count if count is not None else n + 2
    return np.stack([gold_code(degree, i) for i in range(count)])


def barker_code(length: int) -> np.ndarray:
    if length not in BARKER_CODES:
        raise ValueError(
            f"no Barker code of length {length}; "
            f"available: {sorted(BARKER_CODES)}"
        )
    return np.asarray(BARKER_CODES[length], np.int8)


def zadoff_chu(root: int, length: int, shift: int = 0) -> np.ndarray:
    """Zadoff-Chu sequence (zadoff_chu_generator.rs): constant amplitude,
    zero autocorrelation. x[n] = exp(-jπ·u·n·(n+1+2q)/N) for odd N."""
    n = np.arange(length)
    if length % 2 == 0:
        phase = -np.pi * root * n * n / length
    else:
        phase = -np.pi * root * n * (n + 1 + 2 * shift) / length
    return np.exp(1j * phase).astype(np.complex64)


def pn_autocorrelation(chips: np.ndarray) -> np.ndarray:
    """Circular autocorrelation of a ±1 chip sequence (test utility)."""
    n = len(chips)
    f = np.fft.fft(chips.astype(np.float64))
    return np.round(np.real(np.fft.ifft(f * np.conj(f)))).astype(np.int64)


# --------------------------------------------------------------------------
# RAKE receiver (rake_receiver.rs re-design)
# --------------------------------------------------------------------------


def _rake_operands(rx, code):
    rx = to_tensor(rx)
    rx = rx.to(IQ_DTYPE if rx.is_complex() else REAL_DTYPE)
    return rx, to_tensor(code, REAL_DTYPE, rx.device).to(rx.dtype)


def rake_search(rx, code, max_fingers: int = 4, window: int | None = None,
                threshold: float = 0.2):
    """Find multipath fingers by correlating one code period over a
    delay window (rake_receiver.rs:89 search_fingers).

    rx: (N,) complex; code: (L,) ±1 chips at the same rate.
    Returns (delays (F,) int32, gains (F,) complex64, valid (F,) bool):
    up to max_fingers delays whose correlation magnitude exceeds
    threshold × the strongest peak; gains are the normalized complex
    correlations (used as MRC weights). Each pick takes the strongest
    remaining delay (the first on ties) and excludes it and its two
    neighbours; the picks stay on the device.
    """
    rx, c = _rake_operands(rx, code)
    l = c.shape[-1]
    w = int(window) if window is not None else l
    dev = rx.device
    idx = torch.arange(w, device=dev)[:, None] + torch.arange(l, device=dev)[None, :]
    segs = rx[torch.clamp(idx, max=rx.shape[-1] - 1)]
    corr = segs @ c / l  # (W,)
    mag = complex_abs(corr) if corr.is_complex() else torch.abs(corr)
    lags = torch.arange(w, device=dev)
    m, delays = mag, []
    for _ in range(max_fingers):
        d = torch.argmax(m)
        delays.append(d)
        m = torch.where(torch.abs(lags - d) <= 1, -torch.inf, m)
    delays = torch.stack(delays)
    mags = mag[delays]
    return delays.to(torch.int32), corr[delays], mags >= threshold * mags[0]


def _despread(rx: torch.Tensor, c: torch.Tensor, delays: torch.Tensor) -> torch.Tensor:
    """(..., S) per-symbol correlations at each delay of `delays` (...)."""
    l = c.shape[-1]
    n_sym = rx.shape[-1] // l
    dev = rx.device
    idx = (delays.to(torch.int64)[..., None, None]
           + torch.arange(n_sym, device=dev)[:, None] * l + torch.arange(l, device=dev)[None, :])
    segs = rx[torch.clamp(idx, max=rx.shape[-1] - 1)]
    return segs @ c / l


def rake_despread(rx, code, delay) -> torch.Tensor:
    """Despread at one finger delay: per-symbol correlation
    (rake_receiver.rs:145 despread_at). rx (N,), code (L,) → (N//L,)."""
    rx, c = _rake_operands(rx, code)
    return _despread(rx, c, to_tensor(delay, torch.int64, rx.device))


def rake_combine(rx, code, delays, gains, valid=None, mode: str = "mrc") -> torch.Tensor:
    """Multi-finger despread + diversity combining
    (rake_receiver.rs:171 combine; CombiningMode MRC/EGC/Selection).

    Returns (n_sym,) combined soft symbols.
    """
    rx, c = _rake_operands(rx, code)
    dev = rx.device
    gains = to_tensor(gains, IQ_DTYPE, dev)
    delays = to_tensor(delays, torch.int64, dev)
    valid = (torch.ones(delays.shape, dtype=torch.bool, device=dev) if valid is None
             else to_tensor(valid, torch.bool, dev))
    fingers = _despread(rx, c, delays).to(IQ_DTYPE)  # (F, S)
    if mode == "mrc":
        w = torch.conj(gains)
    elif mode == "egc":
        w = torch.conj(gains) / torch.clamp(complex_abs(gains), min=1e-12)
    elif mode == "selection":
        mag = complex_abs(gains)
        best = torch.argmax(torch.where(valid, mag, -1.0))
        pick = torch.arange(gains.shape[0], device=dev) == best
        w = torch.where(pick, torch.conj(gains) / torch.clamp(mag, min=1e-12),
                        torch.zeros_like(gains))
    else:
        raise ValueError(f"unknown combining mode {mode}")
    w = torch.where(valid, w, torch.zeros_like(w))
    return w @ fingers
