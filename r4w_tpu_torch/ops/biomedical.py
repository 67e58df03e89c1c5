"""Biomedical signal-processing fills.

PyTorch counterpart of ``r4w_tpu.ops.biomedical`` (ecg_qrs_detector.rs,
bio_ecg_arrhythmia_classifier.rs, biomedical_signal_processor.rs,
electroencephalogram_bci.rs, electromyography_decomposition.rs,
emg_gesture_decoder.rs, bioacoustic_species_classifier.rs), on the
samples' device.

The QRS chain is the Pan-Tompkins pipeline: its 5-15 Hz bandpass and the
EMG envelope's lowpass run on the FIR kernel (`filters.fir_apply`), the
ECG's baseline removal on the recursion kernel (`filters.dc_blocker`, kind
``linear``). `qrs_detect`, `ecg_clean` and `emg_envelope` take leading
rows, each row kept apart. The moving-window integrator and the syllable
envelope are ``np.convolve(..., mode="same")`` with numpy's centre, which
an even-length box (0.15·fs = 54 samples at 360 Hz) puts half a sample
early (`audio._convolve_same`). Quantiles and medians follow
``jnp.quantile``'s float32 rule (`spectral2.quantile`, `spectral2.median`);
the motor units' ``nanquantile`` takes it over the values that are not
NaN. The spectral features' cumulative sum accumulates in float64 and
rounds once (`filters._cumsum`). Argmax and argmin take the first
extremum, as the reference's do. The rhythm rules and the nearest-template
gesture decision are the reference's numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import complex_abs, linspace
from r4w_tpu_torch.core.types import REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops import filters as _filters
from r4w_tpu_torch.ops.audio import _convolve_same
from r4w_tpu_torch.ops.events import masked_indices, refractory_trigger
from r4w_tpu_torch.ops.packets import _host
from r4w_tpu_torch.ops.spectral2 import _hanning, _interpolate, median, quantile


def _window_peaks(v: torch.Tensor, fires: torch.Tensor, span: int) -> torch.Tensor:
    """fires + the first argmax of v over [fire, fire + span) for each fire;
    v (n,) is read as padded with span + 1 samples of −inf (padded fires
    point at n)."""
    pad = torch.cat([v, torch.full((span + 1,), -torch.inf, dtype=v.dtype, device=v.device)])
    win = fires.long()[:, None] + torch.arange(span, device=v.device)[None, :]
    return fires + torch.argmax(pad[win], dim=1).to(fires.dtype)


# ------------------------------------------------------------- ECG


def qrs_detect(ecg, fs: float, max_peaks: int = 64):
    """Pan–Tompkins QRS detection (ecg_qrs_detector.rs): bandpass
    5–15 Hz → derivative → square → moving-window integrate →
    adaptive-threshold peaks. Fixed-capacity form: returns
    `(r_peaks[..., K] int32, valid[..., K])` for K = max_peaks, in time
    order, for each row of ecg (..., n)."""
    x = to_tensor(ecg, REAL_DTYPE)
    bp = _filters.design_bandpass(int(fs // 2) | 1, 5.0, 15.0, fs)
    f = _filters.fir_apply(bp, x)
    d = torch.cat([f.new_zeros(f.shape[:-1] + (1,)), torch.diff(f, dim=-1)], dim=-1)
    sq = d * d
    w = int(0.15 * fs)
    integ = _convolve_same(sq, np.ones(w, np.float32) / np.float32(w))
    rows = integ.reshape(-1, integ.shape[-1])
    thr = 0.4 * torch.stack([quantile(r, 0.99) for r in rows])
    refractory = max(1, int(0.25 * fs))
    fired = refractory_trigger(rows > thr[:, None], refractory)
    # group delay of the bandpass
    delay = (len(bp) - 1) // 2 + w // 2
    peaks, valids = [], []
    for r, m in zip(rows, fired):
        fires, valid = masked_indices(m, max_peaks)
        p = torch.clamp(_window_peaks(r, fires, refractory) - delay, min=0)
        peaks.append(torch.where(valid, p, 0).to(torch.int32))
        valids.append(valid)
    lead = integ.shape[:-1]
    return (torch.stack(peaks).reshape(lead + (max_peaks,)),
            torch.stack(valids).reshape(lead + (max_peaks,)))


def heart_rate_series(r_peaks, fs: float):
    """Instantaneous heart rate from R-R intervals (on the peaks' device
    when they are a tensor)."""
    rr = np.diff(_host(r_peaks)) / fs
    device = r_peaks.device if isinstance(r_peaks, torch.Tensor) else None
    return to_tensor((60.0 / np.maximum(rr, 1e-3)).astype(np.float32), device=device)


def arrhythmia_classify(r_peaks, fs: float):
    """Rule-based rhythm classification
    (bio_ecg_arrhythmia_classifier.rs): bradycardia/tachycardia/
    afib-like (high RR variability)/normal."""
    rr = np.diff(_host(r_peaks)) / fs
    if rr.shape[0] < 3:
        return "insufficient"
    hr = 60.0 / rr.mean()
    rmssd = np.sqrt(np.mean(np.diff(rr) ** 2))
    if hr < 50.0:
        return "bradycardia"
    if hr > 110.0:
        return "tachycardia"
    if rmssd / rr.mean() > 0.25:
        return "irregular"
    return "normal"


def ecg_clean(ecg, fs: float, mains_hz: float = 50.0):
    """Baseline-wander + mains removal
    (biomedical_signal_processor.rs): DC-blocking high-pass plus a
    mains notch, for each row of ecg (..., n)."""
    x = to_tensor(ecg, REAL_DTYPE)
    y, _ = _filters.dc_blocker(x, alpha=1.0 - 2.0 * np.pi * 0.5 / fs)
    # notch: subtract the Goertzel-estimated mains component
    n = y.shape[-1]
    t = torch.arange(n, dtype=REAL_DTYPE, device=y.device) / real_scalar(fs, y.device)
    arg = (2 * np.pi * mains_hz) * t
    c = torch.cos(arg)
    s = torch.sin(arg)
    a = 2.0 * torch.mean(y * c, dim=-1, keepdim=True)
    b = 2.0 * torch.mean(y * s, dim=-1, keepdim=True)
    return y - a * c - b * s


# ------------------------------------------------------------- EEG


_EEG_BANDS = {"delta": (0.5, 4.0), "theta": (4.0, 8.0),
              "alpha": (8.0, 13.0), "beta": (13.0, 30.0),
              "gamma": (30.0, 45.0)}


def _power_spectrum(x: torch.Tensor) -> torch.Tensor:
    """|rfft(x·hann)|² over the last axis, the window cast to float32."""
    return complex_abs(torch.fft.rfft(x * _hanning(x.shape[-1], x.device), dim=-1)) ** 2


def eeg_band_powers(eeg, fs: float):
    """Canonical EEG band powers (electroencephalogram_bci.rs feature
    stage): one rFFT, masked band sums. Returns dict name→power."""
    x = to_tensor(eeg, REAL_DTYPE)
    n = x.shape[-1]
    spec = _power_spectrum(x)
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    out = {}
    for name, (lo, hi) in _EEG_BANDS.items():
        sel = torch.from_numpy((freqs >= lo) & (freqs < hi)).to(x.device)
        out[name] = torch.sum(torch.where(sel, spec, 0.0), dim=-1)
    return out


def bci_alpha_blocking(eeg_eyes_closed, eeg_eyes_open, fs: float):
    """Simple SSVEP/alpha-blocking BCI decision
    (electroencephalogram_bci.rs): the alpha-power ratio between the
    two states."""
    a_c = eeg_band_powers(eeg_eyes_closed, fs)["alpha"]
    a_o = eeg_band_powers(eeg_eyes_open, fs)["alpha"]
    return a_c / torch.clamp(a_o, min=1e-12)


# ------------------------------------------------------------- EMG


def emg_envelope(emg, fs: float, cutoff_hz: float = 6.0):
    """Rectify + lowpass EMG envelope (electromyography_
    decomposition.rs front end), for each row of emg (..., n)."""
    x = torch.abs(to_tensor(emg, REAL_DTYPE))
    lp = _filters.design_lowpass(int(fs // 4) | 1, cutoff_hz, fs)
    return _filters.fir_apply(lp, x)


def _nanquantile(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.nanquantile(v, q)`` of a 1-D v: the quantile rule over the
    values that are not NaN (they sort last), their count in float32."""
    count = torch.sum(~torch.isnan(v)).to(REAL_DTYPE)
    return _interpolate(v, q, count - 1.0)


def emg_decompose_mu(emg, fs: float, n_units: int = 2,
                     threshold_sigma: float = 4.0,
                     max_peaks: int = 128):
    """Template-free motor-unit firing extraction
    (electromyography_decomposition.rs): peak detection + 2-means
    amplitude clustering into units. Fixed-capacity form: returns
    `(firings[K] int32, unit[K] int32, valid[K])` — firing sample
    indices in time order, each labeled with its motor-unit cluster
    (units ordered by ascending centroid amplitude; unit = -1 on masked
    slots). K = max_peaks."""
    x = to_tensor(emg, REAL_DTYPE)
    a = torch.abs(x)
    n = a.shape[0]
    sd = median(a) * 1.4826
    refractory = max(1, int(0.005 * fs))
    fires, valid = masked_indices(
        refractory_trigger(a > threshold_sigma * sd, refractory), max_peaks)
    ks = _window_peaks(a, fires, refractory)
    amps = a[torch.clamp(ks, max=n - 1).long()]
    # masked 1-D k-means on amplitude, fixed 20 iterations
    amps_q = torch.where(valid, amps, torch.nan)
    cents = _nanquantile(amps_q, linspace(0.2, 0.8, n_units, device=a.device))
    amps_d = torch.where(valid, amps, torch.inf)
    units = torch.arange(n_units, device=a.device)
    for _ in range(20):
        assign = torch.argmin(torch.abs(amps_d[:, None] - cents[None, :]), dim=1)
        onehot = (assign[:, None] == units[None, :]) & valid[:, None]
        cnt = torch.sum(onehot, dim=0, dtype=torch.int32)
        s = torch.sum(torch.where(onehot, amps[:, None], 0.0), dim=0)
        cents = torch.where(cnt > 0, s / torch.clamp(cnt, min=1).to(REAL_DTYPE), cents)
    assign = torch.argmin(torch.abs(amps_d[:, None] - cents[None, :]), dim=1)
    return (torch.where(valid, ks, 0).to(torch.int32),
            torch.where(valid, assign, -1).to(torch.int32), valid)


def emg_gesture_features(emg_channels, fs: float):
    """Per-channel RMS + zero-crossing + waveform-length features
    (emg_gesture_decoder.rs). emg_channels: (C, N)."""
    x = to_tensor(emg_channels, REAL_DTYPE)
    # the root in float64, rounded once: torch's float32 root on the CPU is not
    # correctly rounded
    rms = torch.sqrt(torch.mean(x * x, dim=-1).double()).to(REAL_DTYPE)
    zc = torch.mean((x[:, 1:] * x[:, :-1] < 0).to(REAL_DTYPE), dim=-1)
    wl = torch.mean(torch.abs(torch.diff(x, dim=-1)), dim=-1)
    del fs
    return torch.cat([rms, zc, wl])


def gesture_classify_nn(features, templates: dict):
    """Nearest-template gesture decision (emg_gesture_decoder.rs)."""
    f = _host(features).astype(float)
    best, best_d = None, np.inf
    for name, t in templates.items():
        d = np.linalg.norm(f - _host(t).astype(float))
        if d < best_d:
            best, best_d = name, d
    return best


# -------------------------------------------------------- bioacoustic


def species_features(audio, fs: float):
    """Call features for species classification
    (bioacoustic_species_classifier.rs): peak frequency, bandwidth,
    syllable rate."""
    x = to_tensor(audio, REAL_DTYPE)
    n = x.shape[0]
    spec = _power_spectrum(x)
    f = torch.from_numpy(np.fft.rfftfreq(n, 1.0 / fs).astype(np.float32)).to(x.device)
    pk = f[torch.argmax(spec)]
    csum = _filters._cumsum(spec) / torch.clamp(torch.sum(spec), min=1e-12)
    last = f.shape[0] - 1

    def at(level: float) -> torch.Tensor:
        edge = torch.searchsorted(csum, torch.full((1,), level, dtype=REAL_DTYPE,
                                                   device=x.device))
        return f[torch.clamp(edge, max=last)][0]

    bw = at(0.95) - at(0.05)
    k = max(1, int(0.01 * fs))
    env = _convolve_same(torch.abs(x), np.ones(k, np.float32) / np.float32(k))
    thr = 0.3 * torch.max(env)
    syl = torch.sum(torch.diff((env > thr).to(torch.int32)) == 1, dtype=torch.int32)
    rate = syl.to(REAL_DTYPE) / real_scalar(n / fs, x.device)
    return {"peak_hz": pk, "bandwidth_hz": bw,
            "syllable_rate_hz": rate}


BLOCKS = {
    "ecg_qrs_detector": ("qrs_detect", "measurement",
                         "Pan-Tompkins QRS (ecg_qrs_detector.rs)",
                         ("fs",)),
    "ecg_arrhythmia_classifier": ("arrhythmia_classify", "measurement",
                                  "rhythm rules "
                                  "(bio_ecg_arrhythmia_classifier.rs)",
                                  ("fs",)),
    "biomedical_signal_processor": ("ecg_clean", "filter",
                                    "baseline + mains removal "
                                    "(biomedical_signal_processor.rs)",
                                    ("fs", "mains_hz")),
    "eeg_band_powers": ("eeg_band_powers", "measurement",
                        "delta..gamma powers "
                        "(electroencephalogram_bci.rs)", ("fs",)),
    "eeg_bci": ("bci_alpha_blocking", "measurement",
                "alpha-blocking ratio (electroencephalogram_bci.rs)",
                ("fs",)),
    "emg_decomposition": ("emg_decompose_mu", "measurement",
                          "motor-unit firing extraction "
                          "(electromyography_decomposition.rs)",
                          ("fs", "n_units")),
    "emg_gesture_decoder": ("emg_gesture_features", "measurement",
                            "RMS/ZC/WL features + nearest template "
                            "(emg_gesture_decoder.rs)", ("fs",)),
    "bioacoustic_species_classifier": (
        "species_features", "measurement",
        "call features (bioacoustic_species_classifier.rs)", ("fs",)),
}
