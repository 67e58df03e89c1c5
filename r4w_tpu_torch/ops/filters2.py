"""Filter and rate-conversion fills: the second tier of the filter tail.

PyTorch counterpart of ``r4w_tpu.ops.filters2`` (overlap_add.rs,
overlap_save.rs, matched_filter_bank.rs,
root_raised_cosine_matched_filter_bank.rs, sparse_fir_filter.rs,
lagrange_polynomial_interpolator.rs, mmse_interpolator.rs,
group_delay_equalizer.rs, variable_rate_cic.rs,
interpolating_resampler.rs, sample_rate_converter.rs,
digital_up_converter.rs, frequency_xlating_fft_filter.rs,
frequency_domain_oversampled_dft.rs, log_power_fft.rs,
welch_periodogram.rs, instantaneous_frequency_estimator.rs,
noise_blanker.rs, noise_gate.rs, noise_shaping_quantizer.rs,
dynamic_range_compressor.rs, multiband_compressor.rs, pre_emphasis.rs,
fm_emphasis.rs, filter_synthesis_engine.rs). Samples are on the last axis,
leading axes a batch.

The block convolutions transform all blocks in one batched cuFFT call.
Every FIR runs through `filters.fir_apply`, so on the card through the FIR
kernel, and every oscillator through `kernels.nco.nco_mix_dispatch`. The
recursions run on `kernels.recurrence.first_order_recurrence_dispatch`, one
launch of the Hopper kernel a call on the card: de-emphasis (kind
``linear``), the compressors' envelope follower and the noise gate's gain
(``attack_release``); the noise gate's hysteresis is the parallel
`events.latest_set`. The error-feedback quantizer stays a step loop, as
the reference's ``lax.scan`` is. The tap designs return float32 numpy
arrays, as `filters`' designs do.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import complex_abs, magnitude
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, next_pow2, real_scalar, to_tensor
from r4w_tpu_torch.kernels.nco import nco_mix_dispatch
from r4w_tpu_torch.kernels.recurrence import first_order_recurrence_dispatch, initial_state
from r4w_tpu_torch.ops import filters as _filters
from r4w_tpu_torch.ops import measure as _measure
from r4w_tpu_torch.ops import pulse as _pulse
from r4w_tpu_torch.ops import resample as _resample
from r4w_tpu_torch.ops.events import latest_set

# ------------------------------------------------- FFT block convolution


def _pad_last(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """x with `before` zeros ahead of its last axis and `after` behind."""
    return torch.cat([x.new_zeros(x.shape[:-1] + (before,)), x,
                      x.new_zeros(x.shape[:-1] + (after,))], dim=-1)


def _same_kind(y: torch.Tensor, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return y if x.is_complex() or h.is_complex() else y.real.contiguous()


def overlap_save(x, taps, block: int | None = None):
    """Overlap-save FFT convolution (overlap_save.rs): the causal FIR of x
    with zero state, same length, every block in one batched transform."""
    x = to_tensor(x)
    h = to_tensor(taps, device=x.device)
    m = h.shape[-1]
    if block is None:
        block = max(next_pow2(8 * m), 256)
    nfft = next_pow2(block + m - 1)
    step = nfft - (m - 1)
    n = x.shape[-1]
    n_blocks = -(-n // step)
    padded = _pad_last(x, m - 1, n_blocks * step - n + nfft)
    frames = padded.unfold(-1, nfft, step)[..., :n_blocks, :]
    hf = torch.fft.fft(h, nfft)
    y = torch.fft.ifft(torch.fft.fft(frames, dim=-1) * hf, dim=-1)[..., m - 1:]
    y = y.reshape(*x.shape[:-1], -1)[..., :n]
    return _same_kind(y, x, h)


def overlap_add(x, taps, block: int = 1024):
    """Overlap-add FFT convolution (overlap_add.rs): the full length-(N+M-1)
    linear convolution. Each output sums its blocks' overlapping tails in
    the reference's order (its scatter-add's), never with `index_add_`."""
    x = to_tensor(x)
    h = to_tensor(taps, device=x.device)
    m = h.shape[-1]
    nfft = next_pow2(block + m - 1)
    n = x.shape[-1]
    n_blocks = -(-n // block)
    frames = _pad_last(x, 0, n_blocks * block - n).reshape(*x.shape[:-1], n_blocks, block)
    yb = torch.fft.ifft(torch.fft.fft(frames, nfft, dim=-1) * torch.fft.fft(h, nfft), dim=-1)
    spans = -(-nfft // block)  # blocks of output that one block's transform covers
    parts = _pad_last(yb, 0, spans * block - nfft).reshape(*yb.shape[:-1], spans, block)
    out_len = n_blocks * block + nfft - block
    out = None
    for k in reversed(range(spans)):  # block b + k's output; the earlier block first
        term = _pad_last(parts[..., k, :].reshape(*x.shape[:-1], -1), k * block,
                         (spans - 1 - k) * block)
        out = term if out is None else out + term
    out = out[..., :out_len][..., :n + m - 1]
    return _same_kind(out, x, h)


def frequency_xlating_fft_filter(x, taps, center_hz: float,
                                 sample_rate: float, decim: int = 1):
    """Mix to baseband, FFT-filter, decimate
    (frequency_xlating_fft_filter.rs)."""
    mixed = nco_mix_dispatch(to_tensor(x, IQ_DTYPE), -center_hz, sample_rate)
    return overlap_save(mixed, taps)[..., ::decim]


# ------------------------------------------------------- matched banks


def matched_filter_bank(x, templates):
    """Correlate x (..., N) against a bank of templates (K, M) in one
    batched FFT (matched_filter_bank.rs): (..., K, N) with
    out[k, i] = Σ_u x[i+u]·conj(t_k[u]), the peak at the template's start."""
    x = to_tensor(x, IQ_DTYPE)
    t = to_tensor(templates, IQ_DTYPE, device=x.device)
    n, m = x.shape[-1], t.shape[-1]
    nfft = next_pow2(n + m - 1)
    xf = torch.fft.fft(x, nfft)
    tf = torch.fft.fft(torch.conj(t.flip(-1)), nfft, dim=-1)
    y = torch.fft.ifft(xf[..., None, :] * tf, dim=-1)
    return y[..., m - 1:m - 1 + n]


def rrc_matched_filter_bank(x, sps: int, rolloffs, span: int = 8):
    """Bank of RRC matched filters over candidate roll-offs
    (root_raised_cosine_matched_filter_bank.rs). Returns the (K, N) outputs
    and the index (int32) of the roll-off whose symbol-instant magnitudes
    vary least, at the best symbol phase."""
    banks = np.stack([_pulse.root_raised_cosine_taps(sps, span, float(r)) for r in rolloffs])
    y = matched_filter_bank(x, banks.astype(np.complex64))
    n_sym = y.shape[-1] // sps
    frames = complex_abs(y[..., : n_sym * sps].reshape(*y.shape[:-1], n_sym, sps))
    mean = torch.mean(frames, dim=-2)
    var = torch.var(frames, dim=-2, unbiased=False)
    score = torch.amin(var / torch.clamp(mean ** 2, min=1e-12), dim=-1)
    return y, torch.argmin(score, dim=-1).to(torch.int32)


def sparse_fir_filter(x, tap_values, tap_positions):
    """FIR with few nonzero taps (sparse_fir_filter.rs): a sum of delayed,
    scaled copies, in the taps' order."""
    x = to_tensor(x)
    out = torch.zeros_like(x)
    n = x.shape[-1]
    for v, p in zip(np.asarray(tap_values), np.asarray(tap_positions)):
        p = int(p)
        shifted = _pad_last(x[..., :max(n - p, 0)], min(p, n), 0)
        out = out + float(np.float32(v)) * shifted
    return out


# ------------------------------------------------------- interpolators


def lagrange_interpolator_taps(order: int, mu: float) -> np.ndarray:
    """Lagrange fractional-delay taps (lagrange_polynomial_interpolator.rs):
    h_i = Π_{j≠i}(d-j)/(i-j) for the total delay d = mu + (order-1)//2."""
    d = mu + (order - 1) // 2
    taps = np.ones(order + 1)
    for i in range(order + 1):
        for j in range(order + 1):
            if i != j:
                taps[i] *= (d - j) / (i - j)
    return taps.astype(np.float32)


def lagrange_interpolate(x, mu: float, order: int = 3):
    """Fractional-delay resample by Lagrange polynomial taps."""
    return _filters.fir_apply(lagrange_interpolator_taps(order, mu), x)


def mmse_interpolator_taps(mu: float, n_taps: int = 8, rolloff: float = 0.25) -> np.ndarray:
    """MMSE fractional interpolator taps (mmse_interpolator.rs): a
    Hamming-windowed sinc at the fractional offset, unit DC gain."""
    n = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0 - mu
    taps = np.sinc(n) * np.hamming(n_taps)
    taps /= np.sum(taps)
    return taps.astype(np.float32)


def mmse_interpolate(x, mu: float, n_taps: int = 8):
    return _filters.fir_apply(mmse_interpolator_taps(mu, n_taps), x)


def interpolating_resampler(x, rate: float, n_taps: int = 8):
    """Arbitrary-rate output-driven resampler (interpolating_resampler.rs):
    for each output the input sample below it and windowed-sinc taps at its
    fractional offset, applied by a gather."""
    x = to_tensor(x)
    n_out = int(np.floor(x.shape[-1] / rate))
    pos = torch.arange(n_out, dtype=REAL_DTYPE, device=x.device) * float(np.float32(rate))
    base = torch.floor(pos).to(torch.int64)
    mu = pos - base.to(REAL_DTYPE)
    k = torch.arange(n_taps, dtype=REAL_DTYPE, device=x.device) - (n_taps - 1) / 2.0
    arg = k[None, :] - mu[:, None]
    taps = torch.sinc(arg) * (0.54 + 0.46 * torch.cos(
        math.pi * arg / real_scalar((n_taps + 1) / 2, x.device)))
    taps = taps / torch.sum(taps, dim=-1, keepdim=True)
    xp = _pad_last(x, n_taps // 2, n_taps)
    idx = base[:, None] + torch.arange(n_taps, device=x.device)[None, :]
    gathered = xp[..., idx]
    return torch.sum(gathered * taps.to(x.dtype), dim=-1)


def sample_rate_converter(x, in_rate: float, out_rate: float):
    """Rate converter by ratio (sample_rate_converter.rs): the polyphase
    rational resampler when the ratio is a fraction with a denominator up
    to 64, else the interpolating resampler."""
    fr = Fraction(out_rate / in_rate).limit_denominator(64)
    if abs(float(fr) - out_rate / in_rate) < 1e-9:
        return _resample.rational_resample(x, fr.numerator, fr.denominator)
    return interpolating_resampler(x, in_rate / out_rate)


def digital_up_converter(x, interp: int, center_hz: float,
                         sample_rate_out: float, n_taps: int = 63):
    """DUC: polyphase interpolate by `interp` (anti-image lowpass at the
    output Nyquist/interp), then mix to `center_hz` along the last axis."""
    taps = _filters.design_lowpass(n_taps, sample_rate_out / (2 * interp), sample_rate_out)
    y = _resample.polyphase_interpolate(to_tensor(x, IQ_DTYPE), taps, interp)
    return nco_mix_dispatch(y, center_hz, sample_rate_out)


def variable_rate_cic(x, rate: int, stages: int = 3, interp: bool = False):
    """CIC with a runtime rate (variable_rate_cic.rs). Decimation is the
    carried-state CIC over R^N; interpolation zero-stuffs and applies the
    boxcar^stages kernel (unity DC gain) as one FIR."""
    x = to_tensor(x)
    if interp:
        up = x.new_zeros(x.shape[:-1] + (x.shape[-1] * rate,))
        up[..., ::rate] = x
        kern = np.ones(rate)
        for _ in range(stages - 1):
            kern = np.convolve(kern, np.ones(rate))
        return _filters.fir_apply((kern / (rate ** (stages - 1))).astype(np.float32), up)
    y, _ = _filters.cic_decimator(x, rate, stages)
    return y / real_scalar(rate ** stages, y.device)


# --------------------------------------------------- spectral utilities


def group_delay_equalizer_taps(target_delay, n_taps: int = 63, nfft: int = 512) -> np.ndarray:
    """An FIR whose phase compensates a measured group-delay ripple
    (group_delay_equalizer.rs): the all-pass response exp(-j·φ(ω)) of the
    delay profile, its inverse FFT windowed. float32 numpy, as the
    reference computes it in float32."""
    gd = np.asarray(target_delay, np.float32)
    freqs = np.linspace(0.0, 1.0, gd.shape[0]).astype(np.float32)
    grid = np.interp(np.linspace(0, 1, nfft // 2 + 1).astype(np.float32), freqs,
                     gd).astype(np.float32)
    w = np.pi * np.linspace(0, 1, nfft // 2 + 1)
    phi = (-np.cumsum(grid, dtype=np.float32) * np.float32(w[1] - w[0])).astype(np.float32)
    h_half = (np.cos(phi) + 1j * np.sin(phi)).astype(np.complex64)
    full = np.concatenate([h_half, np.conj(h_half[-2:0:-1])])
    imp = np.real(np.fft.ifft(full)).astype(np.float32)
    imp = np.roll(imp, n_taps // 2)[:n_taps] * np.hamming(n_taps).astype(np.float32)
    return imp.astype(np.float32)


def frequency_domain_oversampled_dft(x, nfft: int, oversample: int = 4):
    """Zero-padded (oversampled) DFT magnitude grid
    (frequency_domain_oversampled_dft.rs)."""
    return complex_abs(torch.fft.fft(to_tensor(x, IQ_DTYPE), nfft * oversample, dim=-1))


def log_power_fft(x, nfft: int = 1024, window: str = "hann", floor_db: float = -200.0):
    """Windowed |FFT|² in dB, averaged over the frames and fftshifted
    (log_power_fft.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    n = (x.shape[-1] // nfft) * nfft
    frames = x[..., :n].reshape(*x.shape[:-1], -1, nfft)
    win = torch.from_numpy((np.hanning(nfft) if window == "hann" else np.ones(nfft))
                           .astype(np.float32)).to(x.device)
    spec = torch.fft.fftshift(torch.fft.fft(frames * win, dim=-1), dim=-1)
    p = torch.mean(complex_abs(spec) ** 2, dim=-2)
    return torch.clamp(10.0 * torch.log10(torch.clamp(p, min=1e-30)), min=floor_db)


def welch_periodogram(x, nfft: int = 1024, overlap: float = 0.5):
    """Named alias of the Welch PSD (welch_periodogram.rs ->
    measure.welch_psd)."""
    return _measure.welch_psd(x, nperseg=nfft, overlap=overlap)


def instantaneous_frequency(x, sample_rate: float = 1.0):
    """Per-sample instantaneous frequency from the phase derivative
    (instantaneous_frequency_estimator.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    d = x[..., 1:] * torch.conj(x[..., :-1])
    f = torch.angle(d) * (sample_rate / (2.0 * np.pi))
    return torch.cat([f[..., :1], f], dim=-1)


# ----------------------------------------------------- noise processing


def noise_blanker(x, threshold_sigma: float = 4.0):
    """Impulse-noise blanker (noise_blanker.rs): zero the samples whose
    magnitude exceeds k·RMS of the whole block."""
    x = to_tensor(x)
    mag = magnitude(x)
    rms = torch.sqrt(torch.mean(mag ** 2))
    return torch.where(mag > threshold_sigma * rms, torch.zeros_like(x), x)


def noise_gate(x, open_db: float, close_db: float | None = None,
               attack: float = 0.5, release: float = 0.01, state: float = 0.0):
    """Hysteresis noise gate with a smoothed gain (noise_gate.rs): the gate
    opens above open_db and closes below close_db (parallel hysteresis),
    and the gain follows it with attack/release smoothing (one recursion
    launch), from `state`."""
    if close_db is None:
        close_db = open_db - 6.0
    x = to_tensor(x)
    mag = magnitude(x)
    opens = mag > float(np.float32(10.0 ** (open_db / 20.0)))
    gate, _ = latest_set(opens | (mag < float(np.float32(10.0 ** (close_db / 20.0)))),
                         opens.to(REAL_DTYPE))
    gains = first_order_recurrence_dispatch(gate, "attack_release", attack, release,
                                            initial_state(gate, state))
    return x * gains


def noise_shaping_quantize(x, n_bits: int, order: int = 1):
    """Error-feedback noise-shaped quantizer (noise_shaper.rs,
    noise_shaping_quantizer.rs): first- or second-order feedback pushes the
    quantization noise to high frequencies. A step loop over the samples."""
    x = to_tensor(x, REAL_DTYPE)
    q = real_scalar(2.0 ** (1 - n_bits), x.device)  # the step for full-scale ±1
    e1 = x.new_zeros(x.shape[:-1])
    e2 = torch.zeros_like(e1)
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        fb = e1 if order == 1 else 2.0 * e1 - e2
        v = x[..., t] + fb
        yq = torch.clamp(torch.round(v / q) * q, -1.0, 1.0)
        y[..., t] = yq
        e1, e2 = v - yq, e1
    return y


# -------------------------------------------------------- compressors


def _env_follow(mag, attack, release, state=0.0):
    """Attack/release envelope of `mag` (one recursion launch): (series,
    final)."""
    mag = to_tensor(mag, REAL_DTYPE)
    series = first_order_recurrence_dispatch(mag, "attack_release", attack, release,
                                             initial_state(mag, state))
    final = series[..., -1] if mag.shape[-1] else initial_state(mag, state)
    return series, final


def dynamic_range_compressor(x, threshold_db: float = -20.0, ratio: float = 4.0,
                             attack: float = 0.1, release: float = 0.005,
                             makeup_db: float = 0.0):
    """Feed-forward compressor with an attack/release envelope
    (dynamic_range_compressor.rs)."""
    x = to_tensor(x)
    series, _ = _env_follow(magnitude(x), attack, release)
    level_db = 20.0 * torch.log10(torch.clamp(series, min=1e-9))
    over = torch.clamp(level_db - threshold_db, min=0.0)
    gain_db = -over * (1.0 - 1.0 / ratio) + makeup_db
    gain = torch.pow(real_scalar(10.0, x.device), gain_db / real_scalar(20.0, x.device))
    return x * gain


def multiband_compressor(x, sample_rate: float, bands_hz=(300.0, 3000.0),
                         thresholds_db=(-25.0, -20.0, -15.0), ratio: float = 4.0,
                         n_taps: int = 101):
    """Split into three bands with complementary FIRs, compress each, and
    sum (multiband_compressor.rs)."""
    x = to_tensor(x, REAL_DTYPE)
    edges = list(bands_hz)
    low_sig = _filters.fir_apply(_filters.design_lowpass(n_taps, edges[0], sample_rate), x)
    mid_sig = _filters.fir_apply(
        _filters.design_bandpass(n_taps, edges[0], edges[1], sample_rate), x)
    out = torch.zeros_like(x)
    for sig, thr in zip([low_sig, mid_sig, x - low_sig - mid_sig], thresholds_db):
        out = out + dynamic_range_compressor(sig, thr, ratio)
    return out


# ------------------------------------------------------- pre-emphasis


def pre_emphasis(x, alpha: float = 0.95):
    """First-difference pre-emphasis y[n]=x[n]-a·x[n-1]
    (pre_emphasis.rs)."""
    x = to_tensor(x, REAL_DTYPE)
    return torch.cat([x[..., :1], x[..., 1:] - alpha * x[..., :-1]], dim=-1)


def de_emphasis(x, alpha: float = 0.95):
    """Inverse of pre_emphasis: one-pole IIR y[n] = fma(α, y[n-1], x[n])
    from y[-1] = 0 (fm_emphasis.rs)."""
    return first_order_recurrence_dispatch(to_tensor(x, REAL_DTYPE), "linear", alpha)


def fm_deemphasis(x, sample_rate: float, tau_us: float = 75.0):
    """Broadcast-FM de-emphasis single-pole IIR with time constant tau
    (fm_emphasis.rs)."""
    dt = 1.0 / sample_rate
    alpha = dt / (tau_us * 1e-6 + dt)
    y, _ = _filters.single_pole_iir(alpha, to_tensor(x, REAL_DTYPE))
    return y


# ----------------------------------------------- filter synthesis engine


def filter_synthesis(kind: str, n_taps: int, sample_rate: float, f1: float,
                     f2: float | None = None, window: str = "hamming") -> np.ndarray:
    """Spec-driven tap synthesis (filter_synthesis_engine.rs): one entry
    point over the windowed-sinc designers."""
    if kind == "lowpass":
        return _filters.design_lowpass(n_taps, f1, sample_rate, window=window)
    if kind == "highpass":
        return _filters.design_highpass(n_taps, f1, sample_rate, window=window)
    if kind in ("bandpass", "bandstop"):
        if f2 is None:
            raise ValueError(f"{kind} needs f2")
        bp = _filters.design_bandpass(n_taps, f1, f2, sample_rate, window=window)
        if kind == "bandpass":
            return bp
        imp = -np.asarray(bp)
        imp[n_taps // 2] += 1.0
        return imp.astype(np.float32)
    raise ValueError(f"unknown filter kind '{kind}'")


BLOCKS = {
    "overlap_save": ("overlap_save", "filter",
                     "overlap-save FFT convolution (overlap_save.rs)",
                     ("block",)),
    "overlap_add": ("overlap_add", "filter",
                    "overlap-add FFT convolution (overlap_add.rs)",
                    ("block",)),
    "fft_filter": ("overlap_save", "filter",
                   "FFT-domain FIR (fft_filter.rs -> overlap_save)"),
    "freq_xlating_fft_filter": (
        "frequency_xlating_fft_filter", "filter",
        "mix + FFT filter + decimate (frequency_xlating_fft_filter.rs)",
        ("center_hz", "sample_rate", "decim")),
    "matched_filter_bank": ("matched_filter_bank", "filter",
                            "batched matched-filter bank "
                            "(matched_filter_bank.rs)"),
    "rrc_matched_filter_bank": (
        "rrc_matched_filter_bank", "filter",
        "RRC bank over roll-offs "
        "(root_raised_cosine_matched_filter_bank.rs)",
        ("sps", "rolloffs")),
    "sparse_fir_filter": ("sparse_fir_filter", "filter",
                          "few-tap FIR (sparse_fir_filter.rs)"),
    "lagrange_interpolator": (
        "lagrange_interpolate", "resampler",
        "Lagrange fractional delay "
        "(lagrange_polynomial_interpolator.rs)", ("mu", "order")),
    "mmse_interpolator": ("mmse_interpolate", "resampler",
                          "MMSE fractional delay (mmse_interpolator.rs)",
                          ("mu",)),
    "interpolating_resampler": (
        "interpolating_resampler", "resampler",
        "output-driven arbitrary resampler "
        "(interpolating_resampler.rs)", ("rate",)),
    "sample_rate_converter": ("sample_rate_converter", "resampler",
                              "ratio rate converter "
                              "(sample_rate_converter.rs)",
                              ("in_rate", "out_rate")),
    "digital_up_converter": ("digital_up_converter", "resampler",
                             "interpolate + mix DUC "
                             "(digital_up_converter.rs)",
                             ("interp", "center_hz")),
    "variable_rate_cic": ("variable_rate_cic", "filter",
                          "runtime-rate CIC (variable_rate_cic.rs)",
                          ("rate", "stages")),
    "group_delay_equalizer": ("group_delay_equalizer_taps", "filter",
                              "group-delay flattening FIR design "
                              "(group_delay_equalizer.rs)"),
    "oversampled_dft": ("frequency_domain_oversampled_dft",
                        "measurement",
                        "zero-padded DFT grid "
                        "(frequency_domain_oversampled_dft.rs)",
                        ("nfft", "oversample")),
    "log_power_fft": ("log_power_fft", "measurement",
                      "averaged log-power spectrum (log_power_fft.rs)",
                      ("nfft",)),
    "welch_periodogram": ("welch_periodogram", "measurement",
                          "Welch PSD (welch_periodogram.rs)", ("nfft",)),
    "instantaneous_frequency": (
        "instantaneous_frequency", "measurement",
        "phase-derivative IF (instantaneous_frequency_estimator.rs)"),
    "noise_blanker": ("noise_blanker", "filter",
                      "impulse blanker (noise_blanker.rs)",
                      ("threshold_sigma",)),
    "noise_gate": ("noise_gate", "filter",
                   "hysteresis noise gate (noise_gate.rs)",
                   ("open_db", "close_db")),
    "noise_shaping_quantizer": (
        "noise_shaping_quantize", "math",
        "error-feedback quantizer (noise_shaping_quantizer.rs)",
        ("n_bits", "order")),
    "dynamic_range_compressor": (
        "dynamic_range_compressor", "filter",
        "attack/release compressor (dynamic_range_compressor.rs)",
        ("threshold_db", "ratio")),
    "multiband_compressor": ("multiband_compressor", "filter",
                             "3-band compressor "
                             "(multiband_compressor.rs)",
                             ("sample_rate", "bands_hz")),
    "pre_emphasis": ("pre_emphasis", "filter",
                     "first-difference pre-emphasis (pre_emphasis.rs)",
                     ("alpha",)),
    "de_emphasis": ("de_emphasis", "filter",
                    "one-pole de-emphasis (fm_emphasis.rs)", ("alpha",)),
    "fm_deemphasis": ("fm_deemphasis", "filter",
                      "75us FM de-emphasis (fm_emphasis.rs)",
                      ("sample_rate", "tau_us")),
    "filter_synthesis": ("filter_synthesis", "filter",
                         "spec-driven tap synthesis "
                         "(filter_synthesis_engine.rs)",
                         ("kind", "n_taps")),
}
