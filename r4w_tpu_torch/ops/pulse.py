"""Pulse-shaping filters: raised-cosine, root-raised-cosine, Gaussian.

PyTorch counterpart of ``r4w_tpu.ops.pulse`` (pulse_shaping.rs: RC :80,
RRC :231, Gaussian :387). The tap designs are numpy copies of the
reference's (float64 on the host, float32 out, bit for bit); shaping and
matched filtering go through `filters.fir_apply`, and so through the
`fir_decimate` kernel on a CUDA tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.ops.filters import _signal, fir_apply


@functools.lru_cache(maxsize=None)
def raised_cosine_taps(sps: int, num_symbols: int = 8,
                       rolloff: float = 0.35) -> np.ndarray:
    """RC impulse response, unit peak, length num_symbols*sps+1."""
    n = num_symbols * sps
    t = (np.arange(n + 1) - n / 2.0) / sps  # in symbol periods
    beta = rolloff
    h = np.sinc(t) * np.cos(np.pi * beta * t)
    denom = 1.0 - (2.0 * beta * t) ** 2
    # limit at t = ±1/(2β)
    sing = np.isclose(denom, 0.0)
    h = np.where(sing, np.pi / 4.0 * np.sinc(1.0 / (2.0 * beta)), h / np.where(sing, 1.0, denom))
    return (h / np.max(np.abs(h))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def root_raised_cosine_taps(sps: int, num_symbols: int = 8,
                            rolloff: float = 0.35) -> np.ndarray:
    """RRC impulse response (pulse_shaping.rs:231), unit energy."""
    n = num_symbols * sps
    t = (np.arange(n + 1) - n / 2.0) / sps
    beta = rolloff
    h = np.empty_like(t)
    for i, ti in enumerate(t):
        if np.isclose(ti, 0.0):
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif beta > 0 and np.isclose(abs(ti), 1.0 / (4.0 * beta)):
            h[i] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta))
            )
        else:
            num = (np.sin(np.pi * ti * (1.0 - beta))
                   + 4.0 * beta * ti * np.cos(np.pi * ti * (1.0 + beta)))
            den = np.pi * ti * (1.0 - (4.0 * beta * ti) ** 2)
            h[i] = num / den
    h = h / np.sqrt(np.sum(h**2))
    return h.astype(np.float32)


@functools.lru_cache(maxsize=None)
def gaussian_taps(sps: int, bt: float = 0.3,
                  num_symbols: int = 4) -> np.ndarray:
    """Gaussian pulse for GMSK/GFSK (pulse_shaping.rs:387), unit area."""
    n = num_symbols * sps
    t = (np.arange(n + 1) - n / 2.0) / sps
    sigma = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt)
    h = np.exp(-(t**2) / (2.0 * sigma**2))
    return (h / h.sum()).astype(np.float32)


def shape_symbols(symbols, taps: np.ndarray, sps: int) -> torch.Tensor:
    """Upsample symbol impulses by sps and convolve with the pulse.

    Full causal convolution: output length = S*sps + len(taps) - 1, with
    symbol i peaking at index i*sps + (len(taps)-1)//2 (the filter group
    delay).
    """
    symbols = _signal(symbols)
    k = len(taps)
    up = symbols.new_zeros(symbols.shape[:-1] + (symbols.shape[-1] * sps + k - 1,))
    up[..., : symbols.shape[-1] * sps : sps] = symbols  # the zero tail flushes the filter
    return fir_apply(taps, up)


def matched_filter(samples, taps: np.ndarray) -> torch.Tensor:
    """Zero-phase matched filter: output aligned with input (same length)."""
    samples = _signal(samples)
    k = len(taps)
    half = (k - 1) // 2
    y = fir_apply(taps, torch.nn.functional.pad(samples, (0, k - 1)))
    return y[..., half : half + samples.shape[-1]]
