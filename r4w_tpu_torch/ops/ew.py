"""Electronic warfare and advanced radar ops: ESPRIT direction and
frequency finding, SAR range-Doppler imaging, passive radar (cross
ambiguity, direct-signal cancellation), GCC-PHAT, TDOA localisation,
ELINT pulse characterisation and ESM spectral surveillance.

PyTorch counterpart of ``r4w_tpu.ops.ew`` (esprit.rs, sar_processor.rs,
passive_radar_processor.rs, tdoa_estimator.rs, emitter_localization.rs,
elint_pulse_characterizer.rs, esm_receiver.rs). The covariance and its
``torch.linalg.eigh`` run on the input's device; ESPRIT's small
non-Hermitian rotation eigensolve (n_sources × n_sources) stays numpy on
the host, as in the reference, and its eigenvalues do not depend on the
signal subspace's basis, so the eigenvectors' phases (LAPACK's or
cuSOLVER's) do not matter. `gcc_phat` clamps its window's start so that the
window fits, as ``lax.dynamic_slice`` does; `cross_ambiguity` and
`cancel_dsi` build their delay lags with the reference's own clamped
gather. `tdoa_localize` is 20 Gauss-Newton steps with no host read.
`pulse_characterize`, `sar_point_target` and the tail of `esm_scan` are the
reference's numpy, copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import complex_abs
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.measure import welch_psd


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -------------------------------------------------------------- ESPRIT


def _esprit_rotation(r: torch.Tensor, n_sources: int) -> np.ndarray:
    """Eigenvalues of the subarray rotation operator from covariance r."""
    _, v = torch.linalg.eigh(r)  # ascending
    es = _host(v[:, -n_sources:])  # signal subspace (M, K)
    # LS solve e1 @ psi = e2; the eigenvalues of psi are the rotations
    psi, *_ = np.linalg.lstsq(es[:-1, :], es[1:, :], rcond=None)
    return np.linalg.eigvals(psi)


def esprit_doa(snapshots, n_sources: int, d: float = 0.5):
    """ESPRIT direction finding on a uniform linear array (esprit.rs:204
    estimate): snapshots (T, M) -> angles_deg (n_sources,) sorted, numpy.
    d = element spacing in wavelengths."""
    x = to_tensor(snapshots, IQ_DTYPE)
    r = (x.T @ x.conj()) / real_scalar(x.shape[0], x.device)  # R[i,j] = E[x_i conj(x_j)]
    mu = np.angle(_esprit_rotation(r, n_sources))  # = -2 pi d sin(theta)
    s = np.clip(-mu / (2 * np.pi * d), -1.0, 1.0)
    return np.sort(np.degrees(np.arcsin(s)))


def esprit_frequencies(x, n_sources: int, m: int = 16):
    """Time-series ESPRIT: n_sources complex-exponential frequencies
    (cycles/sample) of 1-D x from Hankel snapshots, numpy."""
    x = to_tensor(x, IQ_DTYPE).reshape(-1)
    t = x.shape[0] - m + 1
    idx = torch.arange(t, device=x.device)[:, None] + torch.arange(m, device=x.device)[None, :]
    snaps = x[idx]  # (T, M)
    r = (snaps.T @ snaps.conj()) / real_scalar(t, x.device)
    return np.sort(np.angle(_esprit_rotation(r, n_sources)) / (2 * np.pi))


# ----------------------------------------------------------------- SAR


def sar_range_compress(raw, range_ref):
    """Frequency-domain matched filter per pulse (sar_processor.rs:259).
    raw (..., P, N) complex, range_ref (K,) the transmitted chirp."""
    raw = to_tensor(raw, IQ_DTYPE)
    ref = torch.fft.fft(to_tensor(range_ref, IQ_DTYPE, device=raw.device), raw.shape[-1])
    return torch.fft.ifft(torch.fft.fft(raw, dim=-1) * torch.conj(ref), dim=-1)


def sar_azimuth_compress(rc, azimuth_ref):
    """Azimuth matched filter down the pulse axis (sar_processor.rs:332).
    rc (..., P, N) range-compressed, azimuth_ref (P,) the expected Doppler
    history of a point target."""
    rc = to_tensor(rc, IQ_DTYPE)
    ref = torch.fft.fft(to_tensor(azimuth_ref, IQ_DTYPE, device=rc.device), rc.shape[-2])
    return torch.fft.ifft(torch.fft.fft(rc, dim=-2) * torch.conj(ref)[:, None], dim=-2)


def sar_process(raw, range_ref, azimuth_ref):
    """Basic range-Doppler algorithm: range compress -> azimuth compress ->
    magnitude image (sar_processor.rs:234 without RCMC)."""
    return complex_abs(sar_azimuth_compress(sar_range_compress(raw, range_ref), azimuth_ref))


def sar_point_target(n_pulses: int, n_range: int, rng_bin: int,
                     az_bin: int, range_ref, azimuth_ref):
    """Synthetic raw echo of one point scatterer (sar_processor.rs:426
    generate_point_target) for pipeline tests."""
    k = len(_host(range_ref))
    raw = np.zeros((n_pulses, n_range), np.complex64)
    rr = _host(range_ref)
    ar = _host(azimuth_ref)
    for p in range(n_pulses):
        if 0 <= p - az_bin < len(ar) and rng_bin + k <= n_range:
            raw[p, rng_bin:rng_bin + k] += ar[p - az_bin] * rr
    return raw


# -------------------------------------------------------- passive radar


def _lagged(r: torch.Tensor, n: int, lags: int) -> torch.Tensor:
    """(lags, n): r delayed by 0..lags-1 samples, zeros before the start
    (the reference's clamped gather, masked)."""
    idx = torch.arange(n, device=r.device)[None, :] - torch.arange(lags, device=r.device)[:, None]
    return torch.where(idx >= 0, r[torch.clamp(idx, 0, n - 1)], 0.0)


def cross_ambiguity(reference, surveillance, max_delay: int, n_doppler: int | None = None):
    """Cross-ambiguity surface CAF[tau, nu] = sum_t s(t) r*(t-tau) e^{-j2pi nu t}
    (passive_radar_processor.rs:245): one gather builds every delay lag, one
    batched FFT gives every Doppler bin. Returns (caf (max_delay,
    n_doppler), doppler bins in cycles/sample, numpy)."""
    r = to_tensor(reference, IQ_DTYPE)
    s = to_tensor(surveillance, IQ_DTYPE, device=r.device)
    n = min(r.shape[-1], s.shape[-1])
    r, s = r[:n], s[:n]
    caf = torch.fft.fftshift(torch.fft.fft(s[None, :] * torch.conj(_lagged(r, n, max_delay)),
                                           dim=-1), dim=-1)
    freqs = np.fft.fftshift(np.fft.fftfreq(n))
    if n_doppler is not None and n_doppler < n:
        c, h = n // 2, n_doppler // 2
        caf = caf[:, c - h:c - h + n_doppler]
        freqs = freqs[c - h:c - h + n_doppler]
    return caf, freqs


def cancel_dsi(reference, surveillance, n_taps: int = 16):
    """Direct-signal interference cancellation (passive_radar_processor.rs:325):
    least-squares projection of the surveillance channel onto delayed copies
    of the reference (ECA)."""
    r = to_tensor(reference, IQ_DTYPE)
    s = to_tensor(surveillance, IQ_DTYPE, device=r.device)
    n = min(r.shape[-1], s.shape[-1])
    r, s = r[:n], s[:n]
    a = _lagged(r, n, n_taps).T  # (N, T)
    w = torch.linalg.lstsq(a, s[:, None]).solution[:, 0]
    return s - a @ w


# ------------------------------------------------------ TDOA / location


def gcc_phat(x1, x2, max_delay: int | None = None):
    """Generalized cross-correlation with phase transform (tdoa_estimator.rs
    role): returns (delay_samples, correlation). With `max_delay`, the
    window of 2·max_delay + 1 lags around the centre starts where
    ``lax.dynamic_slice`` would start it: clamped so that it fits."""
    a = to_tensor(x1, IQ_DTYPE)
    b = to_tensor(x2, IQ_DTYPE, device=a.device)
    n = a.shape[-1] + b.shape[-1]
    cross = torch.fft.fft(a, n) * torch.conj(torch.fft.fft(b, n))
    cross = cross / torch.clamp(complex_abs(cross), min=1e-12)
    cc = torch.fft.fftshift(torch.fft.ifft(cross).real)
    center = n // 2
    if max_delay is None:
        return torch.argmax(cc) - center, cc
    size = 2 * max_delay + 1
    if size > n:
        raise ValueError(f"gcc_phat: a window of {size} lags exceeds the {n}-lag correlation")
    start = min(max(center - max_delay, 0), n - size)
    cc = cc[start:start + size]
    return torch.argmax(cc) - max_delay, cc


def tdoa_localize(positions, tdoas_m, iters: int = 20):
    """2-D emitter localisation from range differences
    (emitter_localization.rs): positions (R, 2) receiver coordinates,
    tdoas_m (R-1,) range differences d_i - d_0 in metres (receiver 0 is the
    reference). Gauss-Newton from the array centroid, float32."""
    p = to_tensor(positions, REAL_DTYPE)
    dd = to_tensor(tdoas_m, REAL_DTYPE, device=p.device)
    eye = 1e-9 * torch.eye(2, dtype=REAL_DTYPE, device=p.device)
    est = torch.mean(p, dim=0)
    for _ in range(iters):
        d = torch.linalg.vector_norm(p - est, dim=1)
        f = (d[1:] - d[0]) - dd
        u = (est - p) / torch.clamp(d[:, None], min=1e-9)  # d(d_i)/d(est)
        jac = u[1:] - u[0]
        # two unknowns: the (regularised) normal equations
        est = est + torch.linalg.solve(jac.T @ jac + eye, -jac.T @ f)
    return est


# ------------------------------------------------------------- ELINT


def pulse_characterize(x, sample_rate: float, threshold_db: float = 10.0,
                       max_pulses: int = 64, min_width: int = 4):
    """ELINT pulse measurement (elint_pulse_characterizer.rs): detect
    pulses against the noise floor and measure TOA, width, amplitude
    and coarse carrier offset per pulse. Returns a dict of fixed-size
    arrays plus a validity count (static shapes, XLA-style)."""
    x = _host(x)
    env = np.abs(x)
    floor = np.median(env) + 1e-12
    mask = env > floor * 10 ** (threshold_db / 20.0)
    dm = np.diff(mask.astype(np.int8))
    rises = np.where(dm == 1)[0] + 1
    falls = np.where(dm == -1)[0] + 1
    if mask[0]:
        rises = np.concatenate([[0], rises])
    if mask[-1]:
        falls = np.concatenate([falls, [len(x)]])
    # drop noise spikes narrower than min_width samples
    keep = [(a, b) for a, b in zip(rises, falls) if b - a >= min_width]
    rises = np.asarray([a for a, _ in keep], np.int64)
    falls = np.asarray([b for _, b in keep], np.int64)
    n = min(len(rises), len(falls), max_pulses)
    toa = np.zeros(max_pulses)
    width = np.zeros(max_pulses)
    amp = np.zeros(max_pulses)
    freq = np.zeros(max_pulses)
    for i in range(n):
        a, b = rises[i], falls[i]
        toa[i] = a / sample_rate
        width[i] = (b - a) / sample_rate
        seg = x[a:b]
        amp[i] = np.max(np.abs(seg))
        if len(seg) >= 4 and np.iscomplexobj(x):
            spec = np.abs(np.fft.fft(seg, 256))
            freq[i] = np.fft.fftfreq(256, 1 / sample_rate)[np.argmax(spec)]
    pri = np.diff(toa[:n]) if n > 1 else np.zeros(0)
    return {
        "count": n, "toa_s": toa, "width_s": width, "amplitude": amp,
        "carrier_hz": freq,
        "pri_s": float(np.median(pri)) if len(pri) else 0.0,
    }


def esm_scan(x, sample_rate: float, nfft: int = 1024, threshold_db: float = 12.0,
             max_emitters: int = 16):
    """ESM spectral surveillance (esm_receiver.rs): Welch PSD (on the
    samples' device) -> peaks above the noise floor -> emitter list (freq,
    power, bandwidth) on the host."""
    psd = _host(welch_psd(to_tensor(x, IQ_DTYPE), nperseg=nfft, sample_rate=sample_rate))
    # welch_psd returns an already-fftshifted spectrum
    psd_db = 10 * np.log10(np.maximum(psd, 1e-30))
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1 / sample_rate))
    floor = np.median(psd_db)
    above = psd_db > floor + threshold_db
    emitters = []
    i = 0
    while i < nfft and len(emitters) < max_emitters:
        if above[i]:
            j = i
            while j < nfft and above[j]:
                j += 1
            seg = slice(i, j)
            k = i + int(np.argmax(psd_db[seg]))
            emitters.append({
                "freq_hz": float(freqs[k]),
                "power_db": float(psd_db[k] - floor),
                "bandwidth_hz": float((j - i) * sample_rate / nfft),
            })
            i = j
        else:
            i += 1
    return emitters
