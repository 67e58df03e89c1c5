"""Measurement ops: EVM, SNR, the BER tooling, spectra, wavelets, moving
statistics and channel sounding.

PyTorch counterpart of ``r4w_tpu.ops.measure``: EVM, the M2M4 SNR
estimator, bit-error counting, the Wilson confidence interval (numpy, on
the host) and the closed-form AWGN bit error rates, in float32 with
`torch.special.erfc`; the periodogram, Welch PSD, STFT and Goertzel
power; capacity, eye traces and signal power; the Haar/Daubechies DWT,
its inverse and soft-threshold denoising; moving variance, min/max and
autocorrelation; the constellation histogram, noise figures, signal
quality and PN channel sounding. Windowed sums are elementwise products
summed on the last axis, never a matmul, so no TF32 reaches them on the
card. Functions follow the device of a tensor input; other inputs go to
`resolve_device(device)`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.core.windows import make_window
from r4w_tpu_torch.ops.filters import _median, moving_average


def evm_rms(received, reference, normalize: bool = True):
    """RMS error-vector magnitude, optionally normalised by the reference's
    RMS; a linear ratio (×100 = %)."""
    rx = to_tensor(received, IQ_DTYPE)
    ref = to_tensor(reference, IQ_DTYPE, rx.device)
    err = rx - ref
    e = torch.sqrt(torch.mean(err.real ** 2 + err.imag ** 2, dim=-1))
    if normalize:
        p = torch.sqrt(torch.mean(ref.real ** 2 + ref.imag ** 2, dim=-1))
        return e / torch.clamp_min(p, 1e-12)
    return e


def snr_estimate_m2m4(x):
    """Blind M2M4 SNR estimate in dB for constant-modulus signals:
    SNR = sqrt(2·M2² − M4) / (M2 − sqrt(2·M2² − M4))."""
    x = to_tensor(x, IQ_DTYPE)
    p = x.real ** 2 + x.imag ** 2
    m2 = torch.mean(p, dim=-1)
    m4 = torch.mean(p ** 2, dim=-1)
    s = torch.sqrt(torch.clamp_min(2.0 * m2 ** 2 - m4, 0.0))
    n = torch.clamp_min(m2 - s, 1e-12)
    return 10.0 * torch.log10(torch.clamp_min(s / n, 1e-12))


def ber_count(tx_bits, rx_bits):
    """(errors (...,) int64, total) over the common length."""
    tx = to_tensor(tx_bits)
    rx = to_tensor(rx_bits, device=tx.device)
    n = min(tx.shape[-1], rx.shape[-1])
    errs = torch.sum(tx[..., :n] != rx[..., :n], dim=-1, dtype=torch.int64)
    return errs, n


def _norm_ppf(p: float) -> float:
    """Inverse normal CDF (Acklam's approximation)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = np.sqrt(-2 * np.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p <= phigh:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    q = np.sqrt(-2 * np.log(1 - p))
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
           ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)


def ber_confidence_interval(errors: int, total: int, confidence: float = 0.95):
    """Wilson score interval for a BER measurement."""
    if total == 0:
        return 0.0, 1.0
    z = _norm_ppf(1.0 - (1.0 - confidence) / 2.0)
    p = errors / total
    denom = 1.0 + z * z / total
    center = (p + z * z / (2 * total)) / denom
    half = z * np.sqrt(p * (1 - p) / total + z * z / (4 * total * total)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def _ebn0_linear(ebn0_db, device) -> torch.Tensor:
    """10^(dB/10) in float32; the divisor is a float32 tensor, as the
    reference divides (see `real_scalar`)."""
    db = to_tensor(ebn0_db, REAL_DTYPE, device)
    return 10.0 ** (db / real_scalar(10.0, db.device))


def _q(x: torch.Tensor) -> torch.Tensor:
    """Gaussian tail Q(x) = ½·erfc(x/√2), x/√2 a float32 division."""
    return 0.5 * torch.special.erfc(x / real_scalar(math.sqrt(2.0), x.device))


def theoretical_ber_bpsk(ebn0_db, device=None):
    return 0.5 * torch.special.erfc(torch.sqrt(_ebn0_linear(ebn0_db, device)))


def theoretical_ber_qpsk(ebn0_db, device=None):
    return theoretical_ber_bpsk(ebn0_db, device)


def theoretical_ber_mpsk(ebn0_db, m: int, device=None):
    """Gray-coded M-PSK bit error rate.

    Exact for M = 2, 4; the nearest-neighbour approximation
    Pb ≈ (2/k)·Q(√(2k·γb)·sin(π/M)) for M ≥ 8 (tight for Pb ≲ 1e-2).
    """
    if m in (2, 4):
        return theoretical_ber_bpsk(ebn0_db, device)
    k = math.log2(m)
    e = _ebn0_linear(ebn0_db, device) * k
    arg = torch.sqrt(2.0 * e) * math.sin(math.pi / m)
    return 2.0 * _q(arg) / k


def theoretical_ber_fsk_noncoherent(ebn0_db, device=None):
    """Noncoherent orthogonal BFSK: Pb = ½·exp(−γb/2)."""
    return 0.5 * torch.exp(-_ebn0_linear(ebn0_db, device) / 2.0)


def theoretical_ber_mqam_exact(ebn0_db, m: int, device=None):
    """Exact Gray-coded square M-QAM bit error rate (Cho & Yoon 2002, "On
    the general BER expression of one- and two-dimensional amplitude
    modulations"): both dimensions are √M-PAM, and the exact per-bit
    error probabilities are averaged."""
    gamma = _ebn0_linear(ebn0_db, device)
    k_tot = int(np.log2(m))
    sqrt_m = int(round(np.sqrt(m)))
    k_dim = int(np.log2(sqrt_m))
    base = torch.sqrt(3.0 * k_tot * gamma / (m - 1.0))
    total = torch.zeros_like(gamma)
    for k in range(1, k_dim + 1):
        n_terms = int((1 - 2.0 ** (-k)) * sqrt_m)
        for i in range(n_terms):
            f = math.floor(i * 2.0 ** (k - 1) / sqrt_m)
            w = ((-1.0) ** f) * (2.0 ** (k - 1) - math.floor(i * 2.0 ** (k - 1) / sqrt_m + 0.5))
            total = total + (2.0 / sqrt_m) * w * _q((2 * i + 1) * base)
    return total / k_dim


def theoretical_ber_mqam(ebn0_db, m: int, device=None):
    """Gray-coded square M-QAM approximation."""
    k = math.log2(m)
    e = _ebn0_linear(ebn0_db, device) * k
    arg = torch.sqrt(3.0 * e / (m - 1))
    return 4.0 * (1.0 - 1.0 / math.sqrt(m)) * _q(arg) / k


def periodogram_psd(x, nfft: int | None = None, window: str = "hann",
                    sample_rate: float = 1.0):
    """Single-segment windowed periodogram (periodogram_psd.rs).
    Returns PSD in power/Hz, DC-centered."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    nfft = nfft or n
    w = make_window(window, n, x.device)
    spec = torch.fft.fftshift(torch.fft.fft(x * w, n=nfft, dim=-1), dim=-1)
    scale = 1.0 / (torch.sum(w ** 2) * sample_rate)
    return (spec.real ** 2 + spec.imag ** 2) * scale


def _frames(x: torch.Tensor, length: int, hop: int, count: int) -> torch.Tensor:
    """(..., count, length) windows of the last axis, starting every `hop`."""
    return x[..., : (count - 1) * hop + length].unfold(-1, length, hop)


def welch_psd(x, nperseg: int = 256, overlap: float = 0.5,
              window: str = "hann", sample_rate: float = 1.0):
    """Welch-averaged PSD (welch_psd.rs): segment, window, average — all
    segments as one batch axis."""
    x = to_tensor(x, IQ_DTYPE)
    hop = max(1, int(nperseg * (1.0 - overlap)))
    n_seg = max(1, (x.shape[-1] - nperseg) // hop + 1)
    w = make_window(window, nperseg, x.device)
    spec = torch.fft.fftshift(torch.fft.fft(_frames(x, nperseg, hop, n_seg) * w, dim=-1),
                              dim=-1)
    p = (spec.real ** 2 + spec.imag ** 2) / (torch.sum(w ** 2) * sample_rate)
    return torch.mean(p, dim=-2)


def stft(x, nfft: int = 256, hop: int | None = None, window: str = "hann"):
    """Complex STFT frames (stft.rs): (..., frames, nfft)."""
    x = to_tensor(x, IQ_DTYPE)
    hop = hop or nfft // 2
    n_frames = max(0, (x.shape[-1] - nfft) // hop + 1)
    if n_frames == 0:
        return x.new_zeros(x.shape[:-1] + (0, nfft))
    return torch.fft.fft(_frames(x, nfft, hop, n_frames) * make_window(window, nfft, x.device),
                         dim=-1)


def goertzel_power(x, freq_bin: int, n: int | None = None):
    """Single-bin DFT power (goertzel.rs), as a dot with the DFT basis
    (the same O(N), batched)."""
    x = to_tensor(x, IQ_DTYPE)
    n = n or x.shape[-1]
    k = torch.arange(n, dtype=REAL_DTYPE, device=x.device)
    basis = cis(-2 * math.pi * freq_bin * k / real_scalar(n, x.device))
    v = torch.sum(x[..., :n] * basis, dim=-1)
    return v.real ** 2 + v.imag ** 2


def channel_capacity_awgn(snr_db, bandwidth_hz, device=None):
    """Shannon capacity C = B·log2(1+SNR) (channel_capacity.rs)."""
    return bandwidth_hz * torch.log2(1.0 + _ebn0_linear(snr_db, device))


def eye_diagram(x, sps: int, n_traces: int = 64, span: int = 2):
    """(traces, span*sps) overlapped symbol traces (eye_diagram.rs)."""
    x = to_tensor(x)
    w = span * sps
    n = min(n_traces, (x.shape[-1] - w) // sps)
    if n <= 0:
        return x.new_zeros((0, w))
    return _frames(x, w, sps, n)


def signal_power_db(x):
    x = to_tensor(x, IQ_DTYPE)
    return 10.0 * torch.log10(torch.clamp_min(
        torch.mean(x.real ** 2 + x.imag ** 2, dim=-1), 1e-30))


# -------------------------------------------------------------- wavelet


_WAVELETS = {
    "haar": np.asarray([1.0, 1.0]) / np.sqrt(2.0),
    "db2": np.asarray([0.48296291314469025, 0.836516303737469,
                       0.22414386804185735, -0.12940952255092145]),
    "db4": np.asarray([0.23037781330885523, 0.7148465705525415,
                       0.6308807679295904, -0.02798376941698385,
                       -0.18703481171888114, 0.030841381835986965,
                       0.032883011666982945, -0.010597401784997278]),
}


def _qmf(wavelet: str) -> tuple[np.ndarray, np.ndarray]:
    """(lowpass h, highpass g) of a wavelet: g is h reversed with odd taps negated."""
    h = _WAVELETS[wavelet]
    g = h[::-1].copy()
    g[1::2] *= -1.0
    return h, g


def dwt(x, wavelet: str = "haar", levels: int = 1):
    """Multi-level discrete wavelet transform (wavelet.rs): returns
    [cA_L, cD_L, cD_{L-1}, ..., cD_1] (pywt ordering). Each level is one
    strided, periodically extended correlation pair."""
    if wavelet not in _WAVELETS:
        raise ValueError(f"unknown wavelet {wavelet}; know {list(_WAVELETS)}")
    h, g = _qmf(wavelet)
    a = to_tensor(x, REAL_DTYPE)
    lo = torch.as_tensor(h[::-1].copy(), dtype=REAL_DTYPE, device=a.device)  # conv orientation
    hi = torch.as_tensor(g[::-1].copy(), dtype=REAL_DTYPE, device=a.device)
    k = len(h)
    details = []
    for _ in range(levels):
        n = a.shape[-1]
        if n < k:
            break
        ap = torch.cat([a[..., n - (k - 1):], a], dim=-1)  # periodic extension
        frames = _frames(ap, k, 2, (n + 1) // 2)
        details.append(torch.sum(frames * hi, dim=-1))
        a = torch.sum(frames * lo, dim=-1)
    return [a] + details[::-1]


def dwt_denoise(x, wavelet: str = "db4", levels: int = 3,
                threshold: float | None = None):
    """Soft-threshold wavelet denoising: the same-length estimate from the
    inverse transform of the thresholded coefficients."""
    x = to_tensor(x, REAL_DTYPE)
    coeffs = dwt(x, wavelet, levels)
    ca, details = coeffs[0], coeffs[1:]
    if threshold is None:
        # universal threshold from the finest detail band
        sigma = _median(torch.abs(details[-1])) / real_scalar(0.6745, x.device)
        threshold = sigma * torch.sqrt(2.0 * torch.log(real_scalar(float(x.shape[-1]),
                                                                   x.device)))
    soft = [torch.sign(d) * torch.clamp_min(torch.abs(d) - threshold, 0.0) for d in details]
    return idwt([ca] + soft, wavelet)


def idwt(coeffs, wavelet: str = "haar"):
    """Inverse multi-level DWT for the coefficient list from dwt()."""
    h, g = _qmf(wavelet)
    a = to_tensor(coeffs[0], REAL_DTYPE)
    lo = torch.as_tensor(h, dtype=REAL_DTYPE, device=a.device)
    hi = torch.as_tensor(g, dtype=REAL_DTYPE, device=a.device)
    k = len(h)
    for cd in coeffs[1:]:
        cd = to_tensor(cd, REAL_DTYPE, a.device)
        n = cd.shape[-1]
        a = a[..., :n]
        up_a = a.new_zeros(a.shape[:-1] + (2 * n,))
        up_a[..., ::2] = a
        up_d = cd.new_zeros(cd.shape[:-1] + (2 * n,))
        up_d[..., ::2] = cd
        # x[n] = sum_f ca[f] h[2f-n] + cd[f] g[2f-n] (the analysis atoms):
        # windows of the circularly extended streams against the unreversed filters
        up_a = torch.cat([up_a, up_a[..., : k - 1]], dim=-1)
        up_d = torch.cat([up_d, up_d[..., : k - 1]], dim=-1)
        a = (torch.sum(_frames(up_a, k, 1, 2 * n) * lo, dim=-1)
             + torch.sum(_frames(up_d, k, 1, 2 * n) * hi, dim=-1))
    return a


# -------------------------------------------------------- moving stats


def moving_variance(x, length: int):
    """Sliding-window variance (moving_variance.rs) via two moving sums."""
    x = to_tensor(x, REAL_DTYPE)
    m, _ = moving_average(x, length)
    m2, _ = moving_average(x * x, length)
    return torch.clamp_min(m2 - m * m, 0.0)


def moving_minmax(x, length: int):
    """Sliding min and max over a window (moving_minmax.rs): (..., N-L+1) each."""
    w = to_tensor(x).unfold(-1, length, 1)
    return torch.amin(w, dim=-1), torch.amax(w, dim=-1)


def moving_autocorrelation(x, length: int, lag: int = 1):
    """Sliding normalized autocorrelation at a fixed lag
    (moving_autocorrelation.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    m = n - lag - length + 1
    if m <= 0:
        return x.new_zeros(x.shape[:-1] + (0,))
    prod = x[..., lag:] * torch.conj(x[..., : n - lag])
    pwr = x.real ** 2 + x.imag ** 2
    num = torch.sum(_frames(prod, length, 1, m), dim=-1)
    den = torch.sum(_frames(pwr, length, 1, m), dim=-1)
    return num / torch.clamp_min(den, 1e-30)


# ------------------------------------------------- constellation/quality


def constellation_persistence(symbols, bins: int = 64, extent: float = 1.5):
    """2-D constellation density histogram (constellation_tracer.rs GUI
    role): (bins, bins) float32 counts of symbol positions, row = imaginary."""
    s = to_tensor(symbols, IQ_DTYPE).reshape(-1)
    span = real_scalar(2 * extent, s.device)
    xi = torch.clamp(((s.real + extent) / span * bins).to(torch.int32), 0, bins - 1)
    yi = torch.clamp(((s.imag + extent) / span * bins).to(torch.int32), 0, bins - 1)
    counts = torch.bincount((yi * bins + xi).to(torch.int64), minlength=bins * bins)
    return counts.reshape(bins, bins).to(REAL_DTYPE)


def noise_figure_db(gain_db: float, t_noise_k: float,
                    t0_k: float = 290.0):
    """Noise figure from effective noise temperature (noise_figure.rs)."""
    return 10.0 * np.log10(1.0 + t_noise_k / t0_k)


def cascade_noise_figure_db(stages):
    """Friis cascade: stages = [(gain_db, nf_db), ...] -> total NF dB."""
    f_tot = 0.0
    g_acc = 1.0
    for i, (g_db, nf_db) in enumerate(stages):
        f = 10 ** (nf_db / 10.0)
        if i == 0:
            f_tot = f
        else:
            f_tot += (f - 1.0) / g_acc
        g_acc *= 10 ** (g_db / 10.0)
    return 10.0 * np.log10(f_tot)


def signal_quality(symbols, reference):
    """Aggregate link metrics (signal_quality_metrics.rs): EVM %, SNR
    estimate, magnitude/phase error."""
    s = to_tensor(symbols, IQ_DTYPE)
    r = to_tensor(reference, IQ_DTYPE, s.device)
    err = s - r
    p_ref = torch.mean(r.real ** 2 + r.imag ** 2)
    p_err = torch.mean(err.real ** 2 + err.imag ** 2)
    evm = torch.sqrt(p_err / torch.clamp_min(p_ref, 1e-30))
    return {
        "evm_pct": 100.0 * evm,
        "snr_db": 10.0 * torch.log10(torch.clamp_min(
            p_ref / torch.clamp_min(p_err, 1e-30), 1e-30)),
        "mag_err": torch.mean(torch.abs(torch.abs(s) - torch.abs(r))),
        "phase_err_rad": torch.mean(torch.abs(torch.angle(s * torch.conj(r)))),
    }


def channel_sound(rx, probe, n_taps: int = 32):
    """PN-probe channel sounding (channel_sounder.rs /
    channel_sounding_processor.rs): circular-correlate the received
    signal with the known probe sequence and normalize to the channel
    impulse response estimate.

    rx: (..., N) received (probe convolved with the channel + noise);
    probe: (N,) ±1 or complex sounding sequence (one period). Returns
    (..., n_taps) complex CIR estimate.
    """
    rx = to_tensor(rx, IQ_DTYPE)
    p = to_tensor(probe, IQ_DTYPE, rx.device)
    n = p.shape[-1]
    fr = torch.fft.fft(rx[..., :n], dim=-1)
    fp = torch.fft.fft(p)
    cir = torch.fft.ifft(fr * torch.conj(fp), dim=-1)
    energy = torch.sum(torch.abs(p) ** 2)
    return (cir / energy)[..., :n_taps]
