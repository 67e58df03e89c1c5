"""Applied-DSP blocks: denoising, speech, vibration, localization,
source separation, compressive sensing, modulation classification.

PyTorch counterpart of ``r4w_tpu.ops.applied`` (wavelet_denoiser.rs,
spectral_subtraction_denoiser.rs, modulation_classifier.rs,
cepstral_analysis.rs, speech_codec_lpc.rs,
vibration_bearing_fault_detector.rs, trilateration_solver.rs,
blind_source_separation.rs, compressive_sensing.rs,
automatic_modulation_classifier.rs), on the samples' device.

Both overlap-adds of the spectral subtraction sum each sample's frames in
frame order (`audio.overlap_add`). The wavelet threshold's median and the
bearing floor's NaN-median average the two middle values at an even count
(``jnp.median``'s rule; `nanmedian` over the values that are not NaN).
The LPC vocoder's synthesis is a step loop over the samples batched over
the frames (`audio.all_pole`), its Levinson recursion `audio.levinson`.
FastICA takes its start from the reference's host draw and runs its 64
iterations as a loop; OMP picks each atom by the first maximum and solves
the masked Gram system, with no host read between iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import complex_abs
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.audio import _autocorrelation, _ordered_dot, all_pole, levinson, overlap_add
from r4w_tpu_torch.ops.spectral2 import _gather_frames, _hanning, _real, median


def nanmedian(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.nanmedian`` along `dim`: the median of the values that are not
    NaN, the mean of the two middle ones at an even count (NaN when all
    are NaN). ``torch.nanmedian`` takes the lower middle value."""
    s = torch.sort(v, dim=dim).values            # NaNs sort last
    count = torch.sum(~torch.isnan(v), dim=dim, keepdim=True)
    lo = torch.gather(s, dim, torch.clamp((count - 1) // 2, min=0))
    hi = torch.gather(s, dim, torch.clamp(count // 2, min=0, max=v.shape[dim] - 1))
    out = torch.where(count > 0, (lo + hi) * 0.5, torch.full_like(lo, float("nan")))
    return out.squeeze(dim)


# ----------------------------------------------------------- denoise


def spectral_subtraction(x, noise_frames: int = 8, nfft: int = 256,
                         oversubtract: float = 1.5, floor: float = 0.05):
    """Magnitude spectral subtraction (spectral_subtraction_denoiser.rs):
    noise PSD from the first frames, half-overlap add normalised by the
    window's overlap-added square, both sums in frame order. Leading axes
    are rows, each with its own noise estimate."""
    x = _real(x)
    hop = nfft // 2
    n = x.shape[-1]
    n_frames = (n - nfft) // hop + 1
    win = _hanning(nfft, x.device)
    spec = torch.fft.rfft(_gather_frames(x, nfft, hop) * win, dim=-1)
    mag = complex_abs(spec)
    noise = torch.mean(mag[..., :noise_frames, :], dim=-2, keepdim=True)
    clean = torch.maximum(mag - oversubtract * noise, floor * mag)
    m = torch.clamp(mag, min=1e-12)
    out_spec = clean * torch.complex(spec.real / m, spec.imag / m)
    frames_out = torch.fft.irfft(out_spec, n=nfft, dim=-1) * win
    out = overlap_add(frames_out, hop, n)
    norm = overlap_add((win * win).expand(n_frames, nfft), hop, n)
    return out / torch.clamp(norm, min=1e-6)


def wavelet_denoise(x, level: int = 4, threshold_scale: float = 3.0):
    """Haar-wavelet soft-threshold denoiser (wavelet_denoiser.rs):
    universal threshold from the finest-detail MAD estimate (the median
    of all its values, even counts averaged)."""
    x = _real(x)
    n = x.shape[-1]
    n_pad = 1 << int(np.ceil(np.log2(n)))
    a = torch.nn.functional.pad(x, (0, n_pad - n))
    root2 = real_scalar(np.sqrt(2.0), x.device)
    details = []
    for _ in range(level):
        even, odd = a[..., ::2], a[..., 1::2]
        details.append((even - odd) / root2)
        a = (even + odd) / root2
    sigma = median(torch.abs(details[0]).reshape(-1)) / real_scalar(0.6745, x.device)
    thr = threshold_scale * sigma

    def soft(d):
        return torch.sign(d) * torch.clamp(torch.abs(d) - thr, min=0.0)

    for d in reversed(details):
        d = soft(d)
        up = a.new_zeros(a.shape[:-1] + (a.shape[-1] * 2,))
        up[..., ::2] = (a + d) / root2
        up[..., 1::2] = (a - d) / root2
        a = up
    return a[..., :n]


# ------------------------------------------------------------ speech


def real_cepstrum(x, nfft: int | None = None):
    """Real cepstrum c = IFFT(log|FFT(x)|) (cepstral_analysis.rs)."""
    x = _real(x)
    nfft = nfft or x.shape[-1]
    spec = torch.fft.fft(x, n=nfft, dim=-1)
    logmag = torch.log(torch.clamp(complex_abs(spec), min=1e-12))
    return torch.fft.ifft(logmag, dim=-1).real


def cepstral_pitch(x, sample_rate: float, fmin: float = 60.0,
                   fmax: float = 400.0):
    """Pitch from the cepstral peak in the voice quefrency range."""
    c = real_cepstrum(x)
    qmin = int(sample_rate / fmax)
    qmax = int(sample_rate / fmin)
    q = torch.argmax(c[..., qmin:qmax], dim=-1) + qmin
    return real_scalar(sample_rate, c.device) / q.to(REAL_DTYPE)


def lpc_coefficients(x, order: int = 12):
    """LPC via Levinson-Durbin (speech_codec_lpc.rs). Returns (a, g):
    prediction filter a (order+1, a[0]=1) and residual gain g; leading
    axes are rows."""
    x = _real(x)
    n = x.shape[-1]
    # autocorrelation lags 0..order via zero-padded FFT
    ac = _autocorrelation(x, order + 1) / real_scalar(n, x.device)
    return levinson(ac, order)


def lpc_analysis_synthesis(x, order: int = 12, frame: int = 240):
    """Frame-wise LPC vocoder loop: analyze → residual → resynthesize.
    Returns the reconstruction (speech_codec_lpc.rs roundtrip): every
    frame's LPC at once, the residual an FIR of each frame by its own
    filter (terms in order), the synthesis one step loop over the frame's
    samples for all frames."""
    x = _real(x)
    n_frames = (x.shape[-1] - frame) // frame + 1 if x.shape[-1] >= frame \
        else 0
    if n_frames == 0:
        return torch.zeros_like(x)
    segs = x[: n_frames * frame].reshape(n_frames, frame)
    a, _ = lpc_coefficients(segs, order)
    # inverse (FIR) filter: resid[t] = Σ a[k]·x[t−k]
    pad = torch.nn.functional.pad(segs, (order, 0))
    resid = _ordered_dot(a[:, None, :], torch.stack(
        [pad[:, order - k:order - k + frame] for k in range(order + 1)], dim=-1))
    out = all_pole(a, resid).reshape(-1)
    return torch.cat([out, x.new_zeros(x.shape[-1] - out.shape[0])])


# --------------------------------------------------------- vibration


def envelope_spectrum(x, sample_rate: float):
    """Hilbert-envelope spectrum — the bearing-fault workhorse
    (vibration_bearing_fault_detector.rs)."""
    x = _real(x)
    n = x.shape[-1]
    spec = torch.fft.fft(x)
    h = np.zeros(n)
    h[0] = 1.0
    h[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        h[n // 2] = 1.0
    analytic = torch.fft.ifft(spec * torch.from_numpy(h.astype(np.float32)).to(x.device))
    env = complex_abs(analytic)
    env = env - torch.mean(env)
    es = complex_abs(torch.fft.rfft(env)) / real_scalar(n, x.device)
    freqs = torch.from_numpy(np.fft.rfftfreq(n, 1.0 / sample_rate).astype(np.float32)).to(
        x.device)
    return freqs, es


def bearing_fault_metric(x, sample_rate: float, fault_hz: float,
                         harmonics: int = 3, tol_hz: float = 2.0):
    """Fault score: envelope-spectrum energy at the fault frequency and
    harmonics vs the local floor (the NaN-median of the bins above 5 Hz)."""
    freqs, es = envelope_spectrum(x, sample_rate)
    fgrid = np.fft.rfftfreq(_real(x).shape[-1], 1.0 / sample_rate)
    above = torch.from_numpy(fgrid > 5.0).to(es.device)
    floor = nanmedian(torch.where(above, es, torch.full_like(es, float("nan"))))
    score = torch.zeros((), dtype=es.dtype, device=es.device)
    for h in range(1, harmonics + 1):
        mask = np.abs(fgrid - h * fault_hz) <= tol_hz
        if mask.any():
            peak = torch.max(torch.where(torch.from_numpy(mask).to(es.device), es,
                                         torch.full_like(es, -float("inf"))))
            score = score + peak / torch.clamp(floor, min=1e-12)
    return score / real_scalar(harmonics, es.device)


# ------------------------------------------------------ localization


def trilaterate(anchors, ranges) -> torch.Tensor:
    """Least-squares position from anchor ranges
    (trilateration_solver.rs): linearized about anchor 0, the regularised
    normal equations solved in float32."""
    a = _real(anchors)
    r = to_tensor(ranges, REAL_DTYPE, a.device)
    p0, r0 = a[0], r[0]
    rows = a[1:] - p0
    b = 0.5 * (r0 ** 2 - r[1:] ** 2
               + torch.sum((a[1:] - p0) ** 2, dim=1))
    dim = rows.shape[1]
    sol = torch.linalg.solve(
        rows.T @ rows + 1e-9 * torch.eye(dim, dtype=rows.dtype, device=a.device),
        rows.T @ b)
    return p0 + sol


# ----------------------------------------------- source separation


def fastica_2x2(mixtures, iters: int = 64, seed: int = 0):
    """FastICA for two mixed real sources (blind_source_separation.rs):
    whiten then one rotation found by kurtosis maximization, the start
    direction the reference's host draw. The whitening E·D^-½·Eᵀ does not
    depend on the eigenvectors' signs."""
    x = _real(mixtures)  # (2, N)
    x = x - torch.mean(x, dim=1, keepdim=True)
    cov = x @ x.T / real_scalar(x.shape[1], x.device)
    d, e = torch.linalg.eigh(cov)
    white = (e / torch.sqrt(torch.clamp(d, min=1e-12))) @ e.T
    z = white @ x
    rng = np.random.default_rng(seed)  # static init direction
    w0 = rng.standard_normal(2).astype(np.float32)
    w0 /= np.linalg.norm(w0)
    w = torch.from_numpy(w0).to(x.device)
    for _ in range(iters):
        wz = w @ z
        w_new = torch.mean(z * wz ** 3, dim=1) - 3.0 * w
        w = w_new / torch.linalg.vector_norm(w_new)
    basis = torch.stack([w, torch.stack([-w[1], w[0]])])
    return basis @ z, basis @ white


# ------------------------------------------------ compressive sensing


def omp(measurement_matrix, y, sparsity: int):
    """Orthogonal Matching Pursuit (compressive_sensing.rs): recover a
    k-sparse vector from y = A·x. Each atom is the first maximum of the
    correlations outside the support; the coefficients solve the masked
    normal equations (unselected rows of the Gram are identity with a zero
    right-hand side, so their coefficients are exactly 0)."""
    a = _real(measurement_matrix)
    y = to_tensor(y, REAL_DTYPE, a.device)
    n = a.shape[1]
    resid = y
    sel = a.new_zeros(n)  # 1.0 at selected columns
    support = []
    coef_full = a.new_zeros(n)
    for _ in range(sparsity):
        scores = torch.abs(a.T @ resid)
        scores = torch.where(sel > 0, torch.full_like(scores, -1.0), scores)
        j = torch.argmax(scores)
        support.append(j)
        sel = sel.index_fill(0, j[None], 1.0)
        am = a * sel[None, :]
        g = am.T @ am + torch.diag(1.0 - sel)
        coef_full = torch.linalg.solve(g, am.T @ y)
        resid = y - am @ coef_full
    return coef_full, torch.sort(torch.stack(support).to(torch.int32)).values


# -------------------------------------- modulation classification


def modulation_features(x):
    """Normalized cumulant features |C20|, |C40|, C42 plus envelope
    variance (automatic_modulation_classifier.rs feature set)."""
    z = to_tensor(x, IQ_DTYPE)
    z = z / torch.sqrt(torch.mean(complex_abs(z) ** 2))
    z2 = z * z
    z4 = z2 * z2                      # integer powers by squaring, as the reference's
    c20 = torch.mean(z2)
    c21 = torch.mean(complex_abs(z) ** 2)
    c40 = torch.mean(z4) - 3.0 * (c20 * c20)
    c42 = torch.mean(complex_abs(z) ** 2 * z * z) - 2.0 * c20 * c21
    m80 = torch.mean(z4 * z4)
    env = complex_abs(z)
    env_var = torch.mean((env - torch.mean(env)) ** 2)
    return {
        "abs_c20": float(complex_abs(c20)),
        "abs_c40": float(complex_abs(c40)),
        "abs_c42": float(complex_abs(c42)),
        "abs_m80": float(complex_abs(m80)),
        "env_var": float(env_var),
    }


def classify_modulation(x) -> str:
    """Decision-tree AMC over the cumulant features: distinguishes
    BPSK / QPSK / 8PSK-or-PSK / QAM / FM-FSK-like (constant envelope
    with spread spectrum phase)."""
    f = modulation_features(x)
    if f["abs_c20"] > 0.5:
        return "BPSK"
    if f["env_var"] < 0.05:
        # constant envelope: PSK order via the first nonzero moment
        if f["abs_c40"] > 0.5:
            return "QPSK"
        if f["abs_m80"] > 0.3:
            return "8PSK"
        return "FM/FSK"
    return "QAM"
