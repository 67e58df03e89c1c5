"""Synchronization ops: carrier/timing recovery, CFO, frame detection.

PyTorch counterpart of ``r4w_tpu.ops.sync`` (costas_loop.rs, pll.rs,
gardner_ted.rs, mueller_muller_ted.rs, cfo_estimator.rs,
cfo_corrector.rs, correlate_sync.rs, frame_sync.rs,
ofdm_sync_schmidl_cox.rs, dpll.rs, fll_band_edge.rs, pn_sync.rs and the
access-code and burst blocks). Feedback loops are step loops over the
samples, as the reference's ``lax.scan`` is, whose carried state stays a
tensor on the samples' device (no value goes to the host inside a loop);
leading axes of the samples are a batch of independent loops. The
feed-forward estimators are batched: correlations are elementwise
products summed on the last axis or FFT products, never a matmul, so no
TF32 reaches them on the card; the access-code correlation and the burst
detector's moving sums go through `filters.fir_apply`, and so through the
`fir_decimate` kernel on a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.fftops import find_peak_interpolated
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, next_pow2, real_scalar, to_tensor
from r4w_tpu_torch.ops.filters import _cumsum, _median, _stack_steps, fir_apply


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y for an integer y >= 1 by the reference's repeated squaring
    (``lax.integer_pow``: x⁴ = (x·x)·(x·x)), not torch's complex pow."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


# --------------------------------------------------------------------------
# Feed-forward CFO estimation / correction
# --------------------------------------------------------------------------


def cfo_estimate(x, sample_rate, order: int = 1, method: str = "fft"):
    """Blind CFO estimate from x^order (cfo_estimator.rs).

    order=2 for BPSK, 4 for QPSK removes the modulation. method="fft"
    locates the spectral line of x^order with quadratic peak
    interpolation, robust to pulse shaping; method="phase" is the mean
    phase increment (biased by the amplitude nulls of shaped transitions).
    """
    x = to_tensor(x, IQ_DTYPE)
    v = _integer_pow(x, order) if order > 1 else x
    if method == "phase":
        d = v[..., 1:] * torch.conj(v[..., :-1])
        step = torch.angle(torch.sum(d, dim=-1)) / real_scalar(order, x.device)
        return step * sample_rate / real_scalar(2.0 * math.pi, x.device)
    n = next_pow2(v.shape[-1])
    frac_idx, _ = find_peak_interpolated(torch.fft.fft(v, n=n, dim=-1))
    freq = frac_idx / real_scalar(n, x.device)
    freq = torch.where(freq > 0.5, freq - 1.0, freq)  # the signed frequency
    return freq * sample_rate / real_scalar(order, x.device)


def cfo_correct(x, cfo_hz, sample_rate, phase0=0.0):
    """Rotate out a known CFO (cfo_corrector.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    ph = phase0 - 2.0 * math.pi * cfo_hz / sample_rate * torch.arange(
        n, dtype=REAL_DTYPE, device=x.device)
    return x * cis(ph)


# --------------------------------------------------------------------------
# Costas loop / PLL
# --------------------------------------------------------------------------


class LoopOut(NamedTuple):
    y: torch.Tensor           # corrected samples
    freq: torch.Tensor        # per-sample loop frequency (rad/sample)
    phase: torch.Tensor       # final phase
    freq_final: torch.Tensor


def _loop_gains(loop_bw: float) -> tuple[float, float]:
    """(α, β) of the 2nd-order loop with damping 0.7071."""
    zeta = 0.7071
    denom = 1.0 + 2.0 * zeta * loop_bw + loop_bw * loop_bw
    return 4.0 * zeta * loop_bw / denom, 4.0 * loop_bw * loop_bw / denom


def _state(value, x: torch.Tensor) -> torch.Tensor:
    """A loop's initial value as float32 of x's leading shape on x's device."""
    return to_tensor(value, REAL_DTYPE, x.device).expand(x.shape[:-1]).clone()


def _phase_loop(x, loop_bw: float, phase0, freq0, detector) -> LoopOut:
    """v = x·e^{-jφ}; e = detector(v); f += β·e; φ += f + α·e, sample by sample."""
    x = to_tensor(x, IQ_DTYPE)
    alpha, beta = _loop_gains(loop_bw)
    phase, freq = _state(phase0, x), _state(freq0, x)
    ys, freqs = [], []
    for t in range(x.shape[-1]):
        v = x[..., t] * cis(-phase)
        e = detector(v)
        freq = freq + beta * e
        phase = phase + freq + alpha * e
        ys.append(v)
        freqs.append(freq)
    return LoopOut(_stack_steps(ys, x), _stack_steps(freqs, x.real), phase, freq)


def costas_loop(x, loop_bw: float = 0.01, order: int = 2,
                phase0=0.0, freq0=0.0) -> LoopOut:
    """Costas carrier recovery for BPSK(2)/QPSK(4) (costas_loop.rs).

    Standard 2nd-order loop with damping 0.707; error from the
    decision-directed cross product (sign 0 at 0, as the reference's).
    """
    def err(v):
        if order == 2:
            return torch.sign(v.real) * v.imag
        return torch.sign(v.real) * v.imag - torch.sign(v.imag) * v.real

    return _phase_loop(x, loop_bw, phase0, freq0, err)


def pll_track_tone(x, loop_bw: float = 0.02, phase0=0.0, freq0=0.0) -> LoopOut:
    """PLL locking to a complex tone (pll.rs): error = angle of the rotated
    sample."""
    return _phase_loop(x, loop_bw, phase0, freq0, torch.angle)


# --------------------------------------------------------------------------
# Timing error detectors
# --------------------------------------------------------------------------


def gardner_ted(x, sps: int):
    """Gardner timing error per symbol (gardner_ted.rs), non-data-aided.

    e[k] = Re{ (x[k] - x[k-1]) * conj(x[k-1/2]) } on 2x-or-more
    oversampled input, a per-symbol error sequence for a downstream loop.
    """
    x = to_tensor(x, IQ_DTYPE)
    s = x.shape[-1] // sps
    strobes = x[..., : s * sps : sps]
    mid = x[..., sps // 2 : s * sps : sps]
    mid = mid[..., : strobes.shape[-1] - 1]
    d = strobes[..., 1:] - strobes[..., :-1]
    return (d * torch.conj(mid)).real


def mueller_muller_ted(x, sps: int):
    """Mueller & Müller TED (mueller_muller_ted.rs), decision-directed
    with sign decisions."""
    x = to_tensor(x, IQ_DTYPE)
    s = x.shape[-1] // sps
    y = x[..., : s * sps : sps]
    a = torch.complex(torch.sign(y.real), torch.sign(y.imag))
    return ((a[..., :-1] * torch.conj(y[..., 1:])).real
            - (a[..., 1:] * torch.conj(y[..., :-1])).real)


def early_late_gate(x, sps: int):
    """Early-late gate error (early_late_gate.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    s = x.shape[-1] // sps - 1
    on = torch.abs(x[..., sps // 2 : sps // 2 + s * sps : sps])
    early = torch.abs(x[..., sps // 2 - 1 : sps // 2 - 1 + s * sps : sps])
    late = torch.abs(x[..., sps // 2 + 1 : sps // 2 + 1 + s * sps : sps])
    return (late - early) * on


def best_timing_offset(x, sps: int):
    """Feed-forward max-energy timing search (clock_recovery.rs
    replacement): the strobe offset with the largest mean symbol power,
    the first on ties."""
    x = to_tensor(x, IQ_DTYPE)
    s = x.shape[-1] // sps
    trimmed = x[..., : s * sps].reshape(*x.shape[:-1], s, sps)
    power = torch.mean(trimmed.real ** 2 + trimmed.imag ** 2, dim=-2)  # (sps,)
    return torch.argmax(power, dim=-1)


# --------------------------------------------------------------------------
# Frame / preamble detection
# --------------------------------------------------------------------------


def correlate_sync(x, preamble, threshold: float = 0.7):
    """Normalized cross-correlation peak search (correlate_sync.rs,
    frame_sync.rs). Returns (best_offset, peak_metric, metric_series).

    metric[n] = |<x[n:n+L], p>| / (||x[n:n+L]|| · ||p||)
    """
    x = to_tensor(x, IQ_DTYPE)
    p = to_tensor(preamble, IQ_DTYPE, x.device)
    windows = x.unfold(-1, p.shape[-1], 1)  # (..., n_off, L)
    num = torch.abs(torch.sum(windows * torch.conj(p), dim=-1))
    den = torch.sqrt(torch.sum(windows.real ** 2 + windows.imag ** 2, dim=-1)
                     * torch.sum(p.real ** 2 + p.imag ** 2))
    metric = num / torch.clamp_min(den, 1e-12)
    return torch.argmax(metric, dim=-1), torch.amax(metric, dim=-1), metric


def schmidl_cox(x, half_len: int):
    """Schmidl-Cox OFDM timing metric (ofdm_sync_schmidl_cox.rs).

    For a preamble with two identical halves of length L:
      P[d] = Σ_{m<L} conj(x[d+m])·x[d+m+L],  R[d] = Σ |x[d+m+L]|²,
      M[d] = |P|²/R². Returns (d_max, M, P) batched.
    """
    x = to_tensor(x, IQ_DTYPE)
    l = half_len
    n = x.shape[-1] - 2 * l + 1
    if n <= 0:
        z = torch.zeros(x.shape[:-1] + (0,), dtype=REAL_DTYPE, device=x.device)
        return torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device), z, z
    prod = torch.conj(x[..., : x.shape[-1] - l]) * x[..., l:]
    power = x[..., l:].real ** 2 + x[..., l:].imag ** 2

    def sliding(v):  # sums of length l via a cumulative sum
        c = _cumsum(v)
        c = torch.cat([c.new_zeros(c.shape[:-1] + (1,)), c], dim=-1)
        return c[..., l:] - c[..., :-l]

    p = sliding(prod)[..., :n]
    r = sliding(power)[..., :n]
    # relative power floor: quiet regions (R≈0) would otherwise produce
    # spurious M spikes from 0/0
    floor = 0.05 * torch.amax(r, dim=-1, keepdim=True)
    m = (torch.abs(p) ** 2) / torch.maximum(r, floor) ** 2
    return torch.argmax(m, dim=-1), m, p


# --------------------------------------------------------------- dpll


def dpll_advance(errors, alpha: float, beta: float,
                 max_freq: float = np.pi):
    """Second-order PI phase loop driven by an external error sequence
    (dpll.rs advance): returns (phase (N,), freq (N,)), the phase wrapped
    to [-π, π) by a floor modulo.

    Typical alpha=4*BW, beta=4*BW^2 for critical damping.
    """
    e = to_tensor(errors, REAL_DTYPE)
    phase, freq = _state(0.0, e), _state(0.0, e)
    two_pi = real_scalar(2 * np.pi, e.device)
    phs, frs = [], []
    for t in range(e.shape[-1]):
        freq = torch.clamp(freq + beta * e[..., t], -max_freq, max_freq)
        phase = torch.remainder(phase + freq + alpha * e[..., t] + np.pi, two_pi) - np.pi
        phs.append(phase)
        frs.append(freq)
    return _stack_steps(phs, e), _stack_steps(frs, e)


# ---------------------------------------------------------- FLL band-edge


def _band_edge_taps(sps: float, rolloff: float, num_taps: int):
    """Lowpass prototype of width ~rolloff/sps modulated to the two
    band edges at ±(1+rolloff)/(2·sps) cycles/sample (fll_band_edge.rs
    filter design role)."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    bw = rolloff / (2.0 * sps)  # one-sided prototype bandwidth
    proto = np.sinc(2 * bw * n) * np.hamming(num_taps)
    proto /= np.sum(proto)
    fc = (1.0 + rolloff) / (2.0 * sps)
    # the loop computes sum(buffer * taps) with newest sample last, which
    # time-reverses the impulse response — negate the modulation so the
    # "upper" taps really select the +fc band edge
    upper = proto * np.exp(-2j * np.pi * fc * n)
    lower = proto * np.exp(2j * np.pi * fc * n)
    return upper.astype(np.complex64), lower.astype(np.complex64)


def fll_band_edge(x, sps: float, rolloff: float = 0.35,
                  num_taps: int = 45, loop_bw: float = 0.01):
    """Band-edge frequency-locked loop (fll_band_edge.rs): balances
    energy in filters straddling the two spectral band edges; returns
    (corrected, freq_track_rad_per_sample). A step loop over the samples
    of a 1-D stream, its buffer of the last num_taps corrected samples a
    tensor on the samples' device."""
    x = to_tensor(x, IQ_DTYPE)
    up, lo = (torch.from_numpy(t).to(x.device) for t in _band_edge_taps(sps, rolloff, num_taps))
    kp = loop_bw
    ki = 0.25 * loop_bw * loop_bw
    phase = torch.zeros((), dtype=REAL_DTYPE, device=x.device)
    freq = torch.zeros((), dtype=REAL_DTYPE, device=x.device)
    buf = torch.zeros(num_taps, dtype=IQ_DTYPE, device=x.device)
    ys, track = [], []
    for t in range(x.shape[-1]):
        xr = x[..., t] * cis(-phase)
        buf = torch.cat([buf[1:], xr.view(1)])
        e_up = torch.abs(torch.sum(buf * up)) ** 2
        e_lo = torch.abs(torch.sum(buf * lo)) ** 2
        err = torch.clamp((e_lo - e_up) / (e_lo + e_up + 1e-12), -1.0, 1.0)
        freq = torch.clamp(freq - ki * err, -np.pi / 2, np.pi / 2)
        phase = phase + freq - kp * err
        ys.append(xr)
        track.append(freq)
    return _stack_steps(ys, x), _stack_steps(track, x.real)


# ---------------------------------------------------- access code / PN


def access_code_correlate(bits, code):
    """Slide a binary access code over a bit stream; returns the number
    of matching bits at every alignment (access_code_detector.rs).
    bits (..., N) in {0,1}, code (K,) -> (..., N-K+1) match counts."""
    b = 2.0 * to_tensor(bits, REAL_DTYPE) - 1.0
    c = 2.0 * to_tensor(code, REAL_DTYPE, b.device) - 1.0
    k = c.shape[0]
    # y[n] = Σ_j taps[j]·b[n-j] with taps = c reversed: the correlation ending at n
    y = fir_apply(c.flip(0), b)[..., k - 1:]
    return (y + k) / real_scalar(2.0, b.device)  # match count in 0..K


def access_code_detect(bits, code, max_errors: int = 0):
    """Positions where the access code matches within max_errors bit
    flips. Returns a boolean mask over alignments."""
    k = np.asarray(code).shape[0] if not isinstance(code, torch.Tensor) else code.shape[0]
    return access_code_correlate(bits, code) >= (k - max_errors)


def pn_sync_correlate(received, reference):
    """Circular correlation acquisition of a ±1 PN sequence
    (pn_sync.rs PnSynchronizer::correlate): returns (offset, peak,
    correlation magnitudes). Works on real or complex chips."""
    rx = to_tensor(received)
    if not rx.is_complex():
        rx = rx.to(REAL_DTYPE)
    ref = to_tensor(reference, rx.dtype, rx.device)
    n = ref.shape[-1]
    m = rx.shape[-1] // n
    if m >= 1:
        # average code periods coherently for processing gain
        rx_f = torch.mean(rx[..., : m * n].reshape(*rx.shape[:-1], m, n), dim=-2)
    else:
        rx_f = rx[..., :n]
    corr = torch.fft.ifft(torch.fft.fft(rx_f.to(IQ_DTYPE), dim=-1)
                          * torch.conj(torch.fft.fft(ref.to(IQ_DTYPE), n)), dim=-1)
    mag = torch.abs(corr)
    nn = real_scalar(n, rx.device)
    return torch.argmax(mag, dim=-1), torch.amax(mag, dim=-1) / nn, mag / nn


def despread_pn(received, reference, offset):
    """Despread with an aligned PN replica (pn_sync.rs despread)."""
    rx = to_tensor(received)
    ref = to_tensor(reference, device=rx.device)
    n = ref.shape[-1]
    ref_rolled = torch.roll(ref, int(offset))
    m = rx.shape[-1] // n
    chips = rx[..., : m * n].reshape(*rx.shape[:-1], m, n)
    return torch.mean(chips * ref_rolled, dim=-1)


# -------------------------------------------------------------- bursts


def burst_detect(x, window: int = 64, threshold_db: float = 10.0):
    """Energy-rise burst detector (burst_synchronizer.rs role): moving
    power vs the global noise floor (the median of the moving power);
    returns (mask (N,), power_db (N,))."""
    x = to_tensor(x, IQ_DTYPE)
    p = x.real ** 2 + x.imag ** 2
    boxcar = torch.ones(window, dtype=REAL_DTYPE, device=x.device) / real_scalar(window, x.device)
    avg = fir_apply(boxcar, p)
    floor = _median(avg) + 1e-20
    power_db = 10.0 * torch.log10(torch.clamp_min(avg, 1e-30) / floor)
    return power_db > threshold_db, power_db


def burst_synchronize(x, preamble, threshold: float = 0.5):
    """Locate a burst by preamble cross-correlation: returns
    (best_start, metric in 0..1, normalized correlation). Fine timing
    companion to burst_detect."""
    x = to_tensor(x, IQ_DTYPE)
    p = to_tensor(preamble, IQ_DTYPE, x.device)
    k = p.shape[-1]
    n = x.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + k)))
    corr = torch.fft.ifft(torch.fft.fft(x, nfft) * torch.conj(torch.fft.fft(p, nfft)))[: n - k + 1]
    # normalize by the local energy (a moving sum over k) so the metric is |rho| in [0, 1]
    e_local = fir_apply(torch.ones(k, dtype=REAL_DTYPE, device=x.device),
                        x.real ** 2 + x.imag ** 2)[k - 1: n]
    e_p = torch.sum(p.real ** 2 + p.imag ** 2)
    rho = torch.abs(corr) / torch.sqrt(torch.clamp_min(e_local * e_p, 1e-30))
    best = torch.argmax(rho)
    return best, rho[best], rho
