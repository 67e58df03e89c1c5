"""Higher-order & cyclostationary spectral-analysis fills.

PyTorch counterpart of ``r4w_tpu.ops.spectral2`` (cyclic_autocorrelation.rs,
cyclic_spectral_analysis.rs, spectral_correlation_analyzer.rs,
bispectrum_analyzer.rs, empirical_mode.rs, prony_method.rs,
modal_analysis_prony_extended.rs, time_frequency_reassignment.rs,
entropy_calculator.rs, power_law_spectrum_estimator.rs,
phase_coherence_analyzer.rs, expectation_maximization.rs,
matrix_completion_nuclear.rs, tensor_hosvd.rs, subspace_tracker.rs,
adaptive_eigenvalue_tracker.rs, spectrogram_anomaly_detector.rs,
waterfall_image_enhancer.rs, time_raster.rs).

Where the reference materialises a large intermediate, the port forms the
same sums another way:

- `cyclic_autocorrelation` multiplies the (lags, n) lag products by the
  (n, alphas) carriers as one matrix product instead of the (lags, alphas,
  n) tensor; the carrier's phase is the reference's float32 product of
  −2π·α and float32 t, so at long rows it carries float32's spacing
  there (call it a block at a time, as rows, and average).
- `spectral_correlation` takes the frame mean of S(f)·S*(f + a) for every a
  from the (n_fft × n_fft) cross-product over frames, gathered along its
  diagonals, instead of an (n_alpha, frames, n_fft) tensor.
- `emd`'s windowed extrema are a sliding max and min over a
  replicate-padded row (max pooling), exact and equal to the reference's
  clamped (n, w) gather.
- `reassigned_spectrogram` sums each target bin's contributions in source
  order, as the reference's scatter-add does on the CPU, one rank of
  contributions at a time (never an atomic ``index_add_``).
- quantiles and percentiles sort and interpolate at q·(n − 1) with the
  reference's compiled float32 arithmetic (`quantile`, `percentile`:
  1/100 · (n − 1) folded, the second product fused), equal to it, at any
  size; ``torch.quantile`` refuses inputs over 2^24 elements.

SVDs and QR are unique only up to a phase per column, so LAPACK and
cuSOLVER may return other factors than the reference; what is unique
(U·S·Vᴴ, singular values, Q·Qᴴ) is what agrees. `prony` and
`modal_frequencies` are the reference's numpy. Matrix products run in
float32 (the port never enables TF32). `cyclic_autocorrelation`, `emd`
and `spectral_entropy` take leading rows; on one row they give the
reference's result.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs, fma
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor

# ------------------------------------------------------------- helpers


def _device(x) -> torch.device | None:
    """`x`'s device when it is a tensor (None: the default device)."""
    return x.device if isinstance(x, torch.Tensor) else None


def _real(x) -> torch.Tensor:
    """`x` as float32 (the real part of a complex input, as a cast does)."""
    x = to_tensor(x)
    return (x.real if x.is_complex() else x).to(REAL_DTYPE)


def median(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """The median along `dim`: the mean of the two middle values at an even
    length, as ``jnp.median`` (``torch.median`` takes the lower one)."""
    s = torch.sort(v, dim=dim).values
    n = v.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    out = (lo + hi) * 0.5
    return out if keepdim else out.squeeze(dim)


def _interpolate(v: torch.Tensor, scale, factor: torch.Tensor) -> torch.Tensor:
    """The sorted values of `v` at floor and ceil of pos = scale·factor,
    pos in float32, interpolated as the reference's compiled form does:
    low·(1 − w) + high·w with the second product fused into the sum
    (`fma`)."""
    s = torch.sort(v.reshape(-1).to(REAL_DTYPE)).values
    pos = to_tensor(scale, REAL_DTYPE, device=s.device) * factor.to(s.device)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low = torch.clamp(low, min=0.0, max=float(s.numel() - 1)).long()
    high = torch.clamp(high, min=0.0, max=float(s.numel() - 1)).long()
    return fma(s[high], high_w, s[low] * low_w)


def _n_minus_one(v: torch.Tensor) -> torch.Tensor:
    n = real_scalar(float(v.numel()), v.device)
    return n - 1.0


def quantile(v: torch.Tensor, q) -> torch.Tensor:
    """``jnp.quantile(v, q)`` over all elements, linear interpolation: the
    sorted values at floor and ceil of q·(n − 1), position, weights and n
    in float32 as the reference computes them. Works at any size
    (``torch.quantile`` stops at 2^24 elements). `q` a float or a 1-D
    sequence; the result has q's shape."""
    return _interpolate(v, q, _n_minus_one(v))


def percentile(v: torch.Tensor, p: float) -> torch.Tensor:
    """``jnp.percentile(v, p)`` as the reference's compiled form computes
    it: there p / 100 becomes p times the float32 1/100, and that product
    times n − 1 is reassociated to p · (1/100 · (n − 1)), the constants
    folded in float32. Past 2^24 values the plain p / 100 · (n − 1) picks
    another element for some p."""
    c = real_scalar(1.0, v.device) / real_scalar(100.0, v.device)
    return _interpolate(v, p, c * _n_minus_one(v))


def _frames(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(..., n // n_fft, n_fft) consecutive frames of the last axis."""
    n = (x.shape[-1] // n_fft) * n_fft
    return x[..., :n].reshape(*x.shape[:-1], -1, n_fft)


def _gather_frames(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """The reference's ``x[idx]`` frames, idx = f·hop + k for f below
    max(1, (n − n_fft)//hop + 1): a gather that clamps past the end, as
    JAX's does."""
    n = x.shape[-1]
    n_frames = max(1, (n - n_fft) // hop + 1)
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(n_fft, device=x.device)[None, :]).clamp(max=n - 1)
    return x[..., idx]


def _hanning(n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.hanning(n).astype(np.float32)).to(device)


# ------------------------------------------------- cyclostationary


def cyclic_autocorrelation(x, alpha_cycles, max_lag: int = 32):
    """Cyclic autocorrelation R_α(τ) = ⟨x(t+τ)x*(t)e^{-j2παt}⟩ (asymmetric
    form, cyclic_autocorrelation.rs), alpha in cycles/sample. Returns
    (..., n_alpha, 2·max_lag+1) for x (..., n): the lag products (..., lags,
    n) times the carriers (n, alphas), over n."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    t = torch.arange(n, dtype=REAL_DTYPE, device=x.device)
    alphas = torch.atleast_1d(to_tensor(alpha_cycles, REAL_DTYPE, device=x.device))
    phase = (real_scalar(-2.0 * np.pi, x.device) * alphas)[None, :] * t[:, None]
    carriers = cis(phase)                                        # (n, alphas)
    lags = range(-max_lag, max_lag + 1)
    prod = torch.stack([torch.roll(x, -tau, dims=-1) * torch.conj(x) for tau in lags], dim=-2)
    out = (prod @ carriers) / real_scalar(float(n), x.device)     # (..., lags, alphas)
    return out.transpose(-1, -2)


def spectral_correlation(x, n_fft: int = 256, n_alpha: int = 64):
    """FFT-accumulation spectral correlation density estimate
    (spectral_correlation_analyzer.rs / cyclic_spectral_analysis.rs): the
    frame mean of S(f)·S*(f + a) for a below n_alpha, from the frames'
    (n_fft × n_fft) cross-product gathered along its diagonals. Returns the
    (n_alpha, n_fft) magnitude surface."""
    x = to_tensor(x, IQ_DTYPE)
    hop = n_fft // 2
    spec = torch.fft.fft(_gather_frames(x, n_fft, hop) * _hanning(n_fft, x.device), dim=-1)
    f = spec.shape[-2]
    cross = (spec.transpose(-1, -2) @ torch.conj(spec)) / real_scalar(float(f), x.device)
    k = torch.arange(n_fft, device=x.device)
    a = torch.arange(n_alpha, device=x.device)
    scd = cross[..., k[None, :], (k[None, :] + a[:, None]) % n_fft]
    return complex_abs(scd)


def bispectrum(x, n_fft: int = 128):
    """Direct (frame-averaged) bispectrum B(f1,f2) = ⟨X(f1)X(f2)X*(f1+f2)⟩
    (bispectrum_analyzer.rs). Returns the (n_fft//2, n_fft//2) magnitude."""
    x = _real(x)
    frames = _frames(x, n_fft)
    spec = torch.fft.fft(frames * _hanning(n_fft, x.device), dim=-1)
    k = n_fft // 2
    f1 = torch.arange(k, device=x.device)
    sum_idx = (f1[:, None] + f1[None, :]) % n_fft
    b = torch.mean(spec[..., f1][..., :, None] * spec[..., f1][..., None, :]
                   * torch.conj(spec[..., sum_idx]), dim=-3)
    return complex_abs(b)


# --------------------------------------------------------------- EMD


def sliding_extrema(h: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(max, min) over the centred windows of odd length `w` along the last
    axis, the edges replicated: the reference's clamped (n, w) gather, by
    max pooling over a replicate-padded row (exact)."""
    half = w // 2
    rows = h.reshape(-1, 1, h.shape[-1])
    hi = torch.nn.functional.max_pool1d(
        torch.nn.functional.pad(rows, (half, half), mode="replicate"), w, stride=1)
    lo = -torch.nn.functional.max_pool1d(
        torch.nn.functional.pad(-rows, (half, half), mode="replicate"), w, stride=1)
    return hi.reshape(h.shape), lo.reshape(h.shape)


def emd(x, n_imfs: int = 4, n_sift: int = 8):
    """Empirical mode decomposition (empirical_mode.rs): sifting with
    moving max/min envelopes over windows of max(3, n//32)|1 samples.
    Returns (..., n_imfs+1, N): IMFs + residue."""
    r = _real(x)
    n = r.shape[-1]
    w = max(3, n // 32) | 1
    imfs = []
    for _ in range(n_imfs):
        h = r
        for _ in range(n_sift):
            hi, lo = sliding_extrema(h, w)
            h = h - 0.5 * (hi + lo)
        imfs.append(h)
        r = r - h
    imfs.append(r)
    return torch.stack(imfs, dim=-2)


# ------------------------------------------------------------- Prony


def prony(x, order: int):
    """Prony's method (prony_method.rs): fit x[n] = Σ A_k z_k^n, in numpy
    as the reference. Returns (poles z, amplitudes A) complex64."""
    device = _device(x)
    y = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.complex128)
    n = y.shape[0]
    rows = n - order
    a_mat = np.stack([y[i:i + order][::-1] for i in range(rows)])
    b_vec = y[order:order + rows]
    coef, *_ = np.linalg.lstsq(a_mat, b_vec, rcond=None)
    poly = np.concatenate([[1.0], -coef])
    z = np.roots(poly)
    v = np.vander(z, n, increasing=True).T
    amps, *_ = np.linalg.lstsq(v, y, rcond=None)
    return (to_tensor(z.astype(np.complex64), device=device),
            to_tensor(amps.astype(np.complex64), device=device))


def modal_frequencies(x, sample_rate: float, order: int = 8, min_amp: float = 1e-3):
    """Modal analysis via extended Prony (modal_analysis_prony_extended.rs):
    (freq_hz, damping_ratio, amplitude) per retained mode."""
    device = _device(x)
    z, a = prony(x, order)
    z = z.cpu().numpy()
    a = a.cpu().numpy()
    keep = (np.abs(a) > min_amp) & (np.imag(z) > 0)
    z, a = z[keep], a[keep]
    freq = np.angle(z) * sample_rate / (2 * np.pi)
    sigma = np.log(np.maximum(np.abs(z), 1e-12)) * sample_rate
    wn = np.sqrt((2 * np.pi * freq) ** 2 + sigma ** 2)
    zeta = -sigma / np.maximum(wn, 1e-12)
    order_idx = np.argsort(-np.abs(a))
    return (to_tensor(freq[order_idx].astype(np.float32), device=device),
            to_tensor(zeta[order_idx].astype(np.float32), device=device),
            to_tensor(np.abs(a)[order_idx].astype(np.float32), device=device))


# -------------------------------------------------------- reassignment


def ordered_bin_sum(values: torch.Tensor, bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """out[..., b] = the sum of `values` whose `bins` is b along the last
    axis, each bin's terms added in their order (a float32 sum from zero),
    as a sequential scatter-add: a stable sort groups each bin's terms in
    source order, and each rank of terms is added in one step at distinct
    bins. Leading axes are rows."""
    lead = values.shape[:-1]
    v = values.reshape(-1, values.shape[-1])
    b = bins.reshape(-1, bins.shape[-1]).long()
    rows = v.shape[0]
    key = (torch.arange(rows, device=v.device)[:, None] * n_bins + b).reshape(-1)
    key, order = torch.sort(key, stable=True)
    vals = v.reshape(-1)[order]
    pos = torch.arange(key.numel(), device=v.device)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = pos - start
    out = torch.zeros(rows * n_bins, dtype=values.dtype, device=values.device)
    depth = int(rank.max()) + 1 if rank.numel() else 0
    for r in range(depth):
        sel = rank == r
        k = key[sel]
        out[k] = out[k] + vals[sel]
    return out.reshape(*lead, n_bins)


def reassigned_spectrogram(x, sample_rate: float, n_fft: int = 256, hop: int = 64):
    """Time-frequency reassignment (time_frequency_reassignment.rs): each
    frame's energy moved to its bin's instantaneous frequency, from the
    derivative-window STFT ratio; a bin's contributions add in source
    order (`ordered_bin_sum`)."""
    x = to_tensor(x, IQ_DTYPE)
    frames = _gather_frames(x, n_fft, hop)
    h = np.hanning(n_fft)
    dh = np.gradient(h)
    sh = torch.fft.fft(frames * torch.from_numpy(h.astype(np.float32)).to(x.device), dim=-1)
    sdh = torch.fft.fft(frames * torch.from_numpy(dh.astype(np.float32)).to(x.device), dim=-1)
    power = complex_abs(sh) ** 2
    corr = (-torch.imag(sdh * torch.conj(sh)) / torch.clamp(power, min=1e-12)
            * float(n_fft) / real_scalar(2.0 * np.pi, x.device))
    bins = torch.remainder(torch.arange(n_fft, device=x.device, dtype=REAL_DTYPE) + corr,
                           real_scalar(float(n_fft), x.device))
    flat_bins = torch.clamp(torch.round(bins).to(torch.int32), 0, n_fft - 1)
    del sample_rate
    return ordered_bin_sum(power, flat_bins, n_fft)


# --------------------------------------------------------- statistics


def spectral_entropy(x, n_fft: int = 256):
    """Normalized spectral entropy (entropy_calculator.rs): 1 for white
    noise, →0 for a pure tone. x (..., n) gives (...)."""
    x = to_tensor(x)
    spec = torch.mean(complex_abs(torch.fft.fft(_frames(x, n_fft), dim=-1)) ** 2, dim=-2)
    p = spec / torch.clamp(torch.sum(spec, dim=-1, keepdim=True), min=1e-30)
    h = -torch.sum(p * torch.log(torch.clamp(p, min=1e-30)), dim=-1)
    return h / real_scalar(float(np.float32(np.log(n_fft))), x.device)


def power_law_fit(x, sample_rate: float = 1.0, n_fft: int = 1024):
    """Log-log PSD slope (power_law_spectrum_estimator.rs): (exponent β in
    S(f) ∝ f^−β, intercept)."""
    x = _real(x)
    spec = torch.mean(complex_abs(torch.fft.rfft(_frames(x, n_fft), dim=-1)) ** 2, dim=-2)
    f = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    sel = slice(2, n_fft // 4)
    lf = torch.from_numpy(np.log(f[sel]).astype(np.float32)).to(x.device)
    ls = torch.log(torch.clamp(spec[..., sel], min=1e-30))
    lf_c = lf - torch.mean(lf)
    slope = torch.sum(lf_c * ls, dim=-1) / torch.sum(lf_c * lf_c)
    intercept = torch.mean(ls, dim=-1) - slope * torch.mean(lf)
    return -slope, intercept


def phase_locking_value(a, b):
    """Phase coherence between two signals (phase_coherence_analyzer.rs):
    |⟨e^{j(φa−φb)}⟩| ∈ [0, 1]."""
    a = to_tensor(a, IQ_DTYPE)
    b = to_tensor(b, IQ_DTYPE, device=a.device)
    return complex_abs(torch.mean(cis(torch.angle(a) - torch.angle(b)), dim=-1))


def _std(v: torch.Tensor, dim=None) -> torch.Tensor:
    """Population standard deviation (``jnp.std``)."""
    if dim is None:
        return torch.std(v, correction=0)
    return torch.std(v, dim=dim, correction=0)


def em_gmm_1d(x, k: int = 2, n_iter: int = 50, seed: int = 0):
    """1-D Gaussian-mixture EM (expectation_maximization.rs): `n_iter`
    steps from the quantile starts. Returns (means, stds, weights) sorted
    by mean."""
    x = _real(x)
    mu = quantile(x, np.linspace(0.1, 0.9, k).astype(np.float32))
    sig = torch.full((k,), 1.0, dtype=REAL_DTYPE, device=x.device) * (
        _std(x) / real_scalar(float(k), x.device) + 1e-3)
    w = torch.full((k,), 1.0 / k, dtype=REAL_DTYPE, device=x.device)
    del seed
    n = real_scalar(float(x.shape[0]), x.device)
    for _ in range(n_iter):
        d = x[:, None] - mu[None, :]
        logp = -0.5 * (d / sig[None, :]) ** 2 - torch.log(sig[None, :]) + torch.log(w[None, :])
        logp = logp - torch.logsumexp(logp, dim=1, keepdim=True)
        r = torch.exp(logp)
        nk = torch.sum(r, dim=0) + 1e-9
        mu = torch.sum(r * x[:, None], dim=0) / nk
        sig = torch.sqrt(torch.sum(r * (x[:, None] - mu[None, :]) ** 2, dim=0) / nk) + 1e-4
        w = nk / n
    order = torch.sort(mu, stable=True).indices
    return mu[order], sig[order], w[order]


def _svd_project(x: torch.Tensor, rank: int) -> torch.Tensor:
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    s = torch.cat([s[:rank], torch.zeros_like(s[rank:])])
    return (u * s[None, :]) @ vh


def matrix_complete_svt(observed, mask, rank: int | None = None, tau: float | None = None,
                        n_iter: int = 100, step: float = 0.5):
    """Matrix completion (matrix_completion_nuclear.rs). observed: (M,N)
    with zeros at missing entries; mask: 1 where observed. With `rank`:
    hard-impute alternating projection (`tau` and `step` ignored, with a
    warning if tau is given); without: soft-threshold SVT on the dual
    iterate."""
    y = to_tensor(observed, REAL_DTYPE)
    m = to_tensor(mask, REAL_DTYPE, device=y.device)
    if rank is not None:
        if tau is not None:
            warnings.warn("matrix_complete_svt: tau/step are ignored "
                          "when rank is given (hard-impute path)", stacklevel=2)
        x = y
        for _ in range(n_iter):
            x = _svd_project(x, rank)
            x = m * y + (1.0 - m) * x
        return _svd_project(x, rank)
    if tau is None:
        tau = 0.2 * torch.linalg.norm(y)
    z = torch.zeros_like(y)
    x = z
    for _ in range(n_iter):
        u, s, vh = torch.linalg.svd(z, full_matrices=False)
        s = torch.clamp(s - tau * 0.01, min=0.0)
        x = (u * s[None, :]) @ vh
        z = z + step * m * (y - x)
    return x


def hosvd(tensor):
    """Higher-order SVD (tensor_hosvd.rs): (core, factors) with tensor ≈
    core ×₁U₁ ×₂U₂ ×₃U₃."""
    t = to_tensor(tensor, REAL_DTYPE)
    factors = []
    for mode in range(t.ndim):
        unfolded = torch.movedim(t, mode, 0).reshape(t.shape[mode], -1)
        u, _, _ = torch.linalg.svd(unfolded, full_matrices=False)
        factors.append(u)
    core = t
    for mode, u in enumerate(factors):
        core = torch.movedim(torch.tensordot(u.T, torch.movedim(core, mode, 0), dims=1), 0, mode)
    return core, factors


def past_subspace_track(x_stream, n_dim: int = 1, beta: float = 0.97):
    """PAST projection-approximation subspace tracker (subspace_tracker.rs /
    adaptive_eigenvalue_tracker.rs): the dominant n_dim-dimensional subspace
    of a vector stream (T, N), a step loop. Returns (Q orthonormal (N,
    n_dim), column norms per step (T, n_dim))."""
    x = to_tensor(x_stream, IQ_DTYPE)
    n = x.shape[1]
    w = torch.eye(n, n_dim, dtype=IQ_DTYPE, device=x.device)
    p = torch.eye(n_dim, dtype=IQ_DTYPE, device=x.device) * 100.0
    norms = []
    for t in range(x.shape[0]):
        xt = x[t]
        y = w.conj().T @ xt
        h = p @ y
        g = h / (beta + torch.sum(torch.conj(y) * h).real)
        p = (p - torch.outer(g, torch.conj(h))) / beta
        e = xt - w @ y
        w = w + torch.outer(e, torch.conj(g))
        norms.append(torch.linalg.vector_norm(w, dim=0))
    q, _ = torch.linalg.qr(w)
    norms = torch.stack(norms) if norms else torch.zeros((0, n_dim), device=x.device)
    return q, norms


# ----------------------------------------------------- image-ish tools


def spectrogram_anomaly_score(spec_db, n_train: int = 16):
    """Per-frame anomaly score against the first `n_train` frames
    (spectrogram_anomaly_detector.rs): the RMS z-score of each frame's
    bins."""
    s = to_tensor(spec_db, REAL_DTYPE)
    mu = torch.mean(s[:n_train], dim=0)
    sd = _std(s[:n_train], dim=0) + 1e-6
    z = (s - mu[None, :]) / sd[None, :]
    return torch.sqrt(torch.mean(z * z, dim=-1))


def waterfall_enhance(img, gamma: float = 0.5, clip_pct: float = 99.0):
    """Waterfall display enhancement (waterfall_image_enhancer.rs): per-row
    median background removal, percentile clip (`percentile`, any size),
    gamma."""
    x = to_tensor(img, REAL_DTYPE)
    bg = median(x, dim=-1, keepdim=True)
    x = torch.clamp(x - bg, min=0.0)
    hi = percentile(x, clip_pct)
    x = torch.clamp(x / torch.clamp(hi, min=1e-12), 0.0, 1.0)
    return x ** gamma


def time_raster(bits, width: int):
    """Fold a bit/byte stream into a 2-D raster (time_raster.rs)."""
    b = to_tensor(bits)
    n = (b.shape[0] // width) * width
    return b[:n].reshape(-1, width)


BLOCKS = {
    "cyclic_autocorrelation": ("cyclic_autocorrelation", "measurement",
                               "R_alpha(tau) surface "
                               "(cyclic_autocorrelation.rs)",
                               ("alpha_cycles", "max_lag")),
    "spectral_correlation_analyzer": (
        "spectral_correlation", "measurement",
        "SCD estimate (spectral_correlation_analyzer.rs)",
        ("n_fft", "n_alpha")),
    "bispectrum_analyzer": ("bispectrum", "measurement",
                            "frame-averaged bispectrum "
                            "(bispectrum_analyzer.rs)", ("n_fft",)),
    "empirical_mode": ("emd", "measurement",
                       "EMD sifting (empirical_mode.rs)",
                       ("n_imfs", "n_sift")),
    "prony_method": ("prony", "measurement",
                     "damped-exponential fit (prony_method.rs)",
                     ("order",)),
    "modal_analysis_prony": ("modal_frequencies", "measurement",
                             "modal freq/damping "
                             "(modal_analysis_prony_extended.rs)",
                             ("sample_rate", "order")),
    "time_frequency_reassignment": (
        "reassigned_spectrogram", "measurement",
        "reassigned STFT (time_frequency_reassignment.rs)",
        ("sample_rate", "n_fft")),
    "entropy_calculator": ("spectral_entropy", "measurement",
                           "normalized spectral entropy "
                           "(entropy_calculator.rs)", ("n_fft",)),
    "power_law_spectrum_estimator": (
        "power_law_fit", "measurement",
        "1/f^beta slope fit (power_law_spectrum_estimator.rs)"),
    "phase_coherence_analyzer": ("phase_locking_value", "measurement",
                                 "phase-locking value "
                                 "(phase_coherence_analyzer.rs)"),
    "expectation_maximization": ("em_gmm_1d", "math",
                                 "1-D GMM EM "
                                 "(expectation_maximization.rs)",
                                 ("k", "n_iter")),
    "matrix_completion_nuclear": ("matrix_complete_svt", "math",
                                  "SVT matrix completion "
                                  "(matrix_completion_nuclear.rs)",
                                  ("rank", "n_iter")),
    "tensor_hosvd": ("hosvd", "math", "higher-order SVD "
                     "(tensor_hosvd.rs)"),
    "subspace_tracker": ("past_subspace_track", "math",
                         "PAST subspace tracking "
                         "(subspace_tracker.rs / "
                         "adaptive_eigenvalue_tracker.rs)",
                         ("n_dim", "beta")),
    "spectrogram_anomaly_detector": (
        "spectrogram_anomaly_score", "measurement",
        "frame anomaly score (spectrogram_anomaly_detector.rs)",
        ("n_train",)),
    "waterfall_image_enhancer": ("waterfall_enhance", "sink",
                                 "clip+gamma+background removal "
                                 "(waterfall_image_enhancer.rs)",
                                 ("gamma", "clip_pct")),
    "time_raster": ("time_raster", "sink",
                    "stream folding raster (time_raster.rs)",
                    ("width",)),
}
