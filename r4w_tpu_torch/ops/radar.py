"""Radar, EW and direction-finding ops: pulse compression, 1-D and 2-D
CA-CFAR, range-Doppler maps, MTI, ULA steering, MUSIC, MVDR, beamforming
and the ambiguity function.

PyTorch counterpart of ``r4w_tpu.ops.radar`` (cfar.rs, cfar_2d.rs,
pulse_compressor.rs, range_doppler_map.rs, mti_filter.rs, music_doa.rs,
mvdr_beamformer.rs, beamformer.rs, ambiguity_function.rs). Transforms are
batched cuFFT calls over the last axes, so a cube or a snapshot matrix may
carry leading batch axes (beams, elements, CPIs) and equals the reference
on the reference's shape.

`cfar_1d` sums its training window through `filters.fir_apply`, so on the
card it runs the `fir_decimate` kernel, as every FIR of the port does.
`cfar_2d` sums its ring of training cells with one ``F.conv2d`` of the ring
itself (never a box minus its inner box, which cancels digits when a strong
target sits in the guard cells), with cuDNN's TF32 off around the call: on
by default for convolutions, it would round the noise sums to 10 bits and
move the thresholds. `music_spectrum` takes ``torch.linalg.eigh``
(ascending eigenvalues, as in the reference; the eigenvectors' phases
differ between LAPACK and cuSOLVER, the projection norms do not) and
`mvdr_weights` ``torch.linalg.solve``, both on the sample covariance
accumulated in complex128: with an interferer 30 dB over the noise the
covariance's condition reaches 10^4 and more, a float32 solve's weights
then differ between LAPACK and cuSOLVER by ~1e-4, which leaks the jammer
into the beams by a few percent of the noise and moves CFAR decisions, and
MUSIC's noise subspace next to a weak target's eigenvalue is as sensitive;
in float64 the card and the CPU agree to complex64 rounding, and the
reference's float32 results lie within its own float32 error of them. The
port never enables TF32 for matrix products. Divisors are float32 tensors (`real_scalar`), so the card
divides as the CPU and the reference do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.filters import fir_apply


def _nfft(n: int) -> int:
    return 1 << (n - 1).bit_length()


def pulse_compress(rx, pulse) -> torch.Tensor:
    """Matched-filter pulse compression (pulse_compressor.rs): correlate rx
    against the known transmit pulse via FFT."""
    rx = to_tensor(rx, IQ_DTYPE)
    p = to_tensor(pulse, IQ_DTYPE, device=rx.device)
    nfft = _nfft(rx.shape[-1] + p.shape[-1] - 1)
    r_f = torch.fft.fft(rx, n=nfft, dim=-1)
    p_f = torch.fft.fft(p, n=nfft)
    return torch.fft.ifft(r_f * torch.conj(p_f), dim=-1)[..., : rx.shape[-1]]


def _ca_alpha(n_train: float, pfa: float) -> float:
    return n_train * (pfa ** (-1.0 / n_train) - 1.0)


def _edge_pad(p: torch.Tensor, win: int) -> torch.Tensor:
    """`p` with `win` copies of its first and last sample on the last axis."""
    shape = (*p.shape[:-1], win)
    return torch.cat([p[..., :1].expand(shape), p, p[..., -1:].expand(shape)], dim=-1)


def cfar_1d(power, guard: int = 2, train: int = 8, pfa: float = 1e-4):
    """Cell-averaging CFAR (cfar.rs): (detection mask, threshold).

    The training-cell sum is a FIR over the edge-padded power; α from the
    standard CA-CFAR formula α = N·(Pfa^(-1/N) − 1)."""
    p = to_tensor(power, REAL_DTYPE)
    n_train = 2 * train
    win = guard + train
    kernel = np.zeros(2 * win + 1, np.float32)
    kernel[:train] = 1.0
    kernel[-train:] = 1.0
    ext = _edge_pad(p, win)
    sums = fir_apply(kernel, ext)[..., 2 * win:]
    threshold = _ca_alpha(n_train, pfa) * (sums / real_scalar(n_train, p.device))
    return p > threshold, threshold


def cfar_2d(power, guard: int = 1, train: int = 4, pfa: float = 1e-4):
    """2-D CA-CFAR over a range-Doppler map (cfar_2d.rs): (mask,
    threshold) over the last two axes, leading axes a batch."""
    p = to_tensor(power, REAL_DTYPE)
    win = guard + train
    size = 2 * win + 1
    ring = np.ones((size, size), np.float32)
    g = 2 * guard + 1
    ring[train:train + g, train:train + g] = 0.0
    n_train = float(ring.sum())
    batch = p.shape[:-2]
    flat = p.reshape(-1, 1, *p.shape[-2:])
    ext = F.pad(flat, (win, win, win, win), mode="replicate")
    kernel = torch.from_numpy(ring).to(p.device)[None, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        sums = F.conv2d(ext, kernel)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    noise = sums.reshape(*batch, *p.shape[-2:]) / real_scalar(n_train, p.device)
    threshold = _ca_alpha(n_train, pfa) * noise
    return p > threshold, threshold


def range_doppler_map(pulses, pulse_ref=None) -> torch.Tensor:
    """(..., n_pulses, n_range) slow-time × fast-time -> |RD map|²
    (range_doppler_map.rs): optional pulse compression, then the FFT
    across pulses."""
    x = to_tensor(pulses, IQ_DTYPE)
    if pulse_ref is not None:
        x = pulse_compress(x, pulse_ref)
    rd = torch.fft.fftshift(torch.fft.fft(x, dim=-2), dim=-2)
    return rd.real ** 2 + rd.imag ** 2


def mti_filter(pulses, order: int = 2) -> torch.Tensor:
    """Moving-target-indication canceller (mti_filter.rs): the binomial
    difference across pulses (axis -2) removes stationary clutter."""
    x = to_tensor(pulses, IQ_DTYPE)
    for _ in range(order):
        x = x[..., 1:, :] - x[..., :-1, :]
    return x


def steering_vector(n_elements: int, spacing_wavelengths: float, angles_deg,
                    device=None) -> torch.Tensor:
    """ULA steering vectors: (n_angles, n_elements) (a scalar angle gives
    (n_elements,)). A tensor of angles keeps its device; anything else
    goes to `device` (default: the card)."""
    ang = torch.deg2rad(to_tensor(angles_deg, REAL_DTYPE, device=device))
    k = 2.0 * math.pi * spacing_wavelengths
    n = torch.arange(n_elements, dtype=REAL_DTYPE, device=ang.device)
    return cis((k * torch.sin(ang))[..., None] * n)


def _covariance(x: torch.Tensor) -> torch.Tensor:
    """The sample covariance x·xᴴ/T of complex64 snapshots (..., M, T),
    accumulated and returned in complex128."""
    x = x.to(torch.complex128)
    return (x @ x.conj().transpose(-2, -1)) / x.shape[-1]


def music_spectrum(snapshots, n_sources: int, spacing_wavelengths: float = 0.5,
                   scan_deg=None):
    """MUSIC DoA pseudo-spectrum (music_doa.rs): noise-subspace projection
    over a scan grid. snapshots (..., n_elements, n_snapshots) -> (scan,
    spectrum (..., n_scan))."""
    x = to_tensor(snapshots, IQ_DTYPE)
    m = x.shape[-2]
    _, vecs = torch.linalg.eigh(_covariance(x))
    en = vecs[..., :, : m - n_sources].to(IQ_DTYPE)  # noise subspace (ascending eigenvalues)
    scan = to_tensor(scan_deg if scan_deg is not None else np.linspace(-90, 90, 181), REAL_DTYPE,
                     device=x.device)
    a = steering_vector(m, spacing_wavelengths, scan)  # (A, M)
    proj = torch.conj(a) @ en                          # (..., A, K)
    denom = torch.sum(proj.real ** 2 + proj.imag ** 2, dim=-1)
    return scan, 1.0 / torch.clamp(denom, min=1e-12)


def mvdr_weights(snapshots, look_deg, spacing_wavelengths: float = 0.5,
                 diagonal_loading: float = 1e-3):
    """MVDR/Capon beamformer weights (mvdr_beamformer.rs):
    w = R⁻¹a / (aᴴR⁻¹a), from snapshots (..., M, T). A scalar `look_deg`
    gives (..., M); a sequence of L looks gives (..., L, M), every look
    solved against the one covariance in one call."""
    x = to_tensor(snapshots, IQ_DTYPE)
    m = x.shape[-2]
    r = _covariance(x) + diagonal_loading * torch.eye(m, dtype=torch.complex128, device=x.device)
    scalar = (look_deg.ndim == 0 if isinstance(look_deg, torch.Tensor)
              else np.ndim(look_deg) == 0)
    looks = to_tensor(look_deg, REAL_DTYPE, device=x.device).reshape(-1)
    a = steering_vector(m, spacing_wavelengths, looks).to(torch.complex128)  # (L, M)
    ri_a = torch.linalg.solve(r[..., None, :, :], a[..., None])[..., 0]     # (..., L, M)
    w = (ri_a / torch.sum(torch.conj(a) * ri_a, dim=-1, keepdim=True)).to(IQ_DTYPE)
    return w[..., 0, :] if scalar else w


def beamform(snapshots, weights) -> torch.Tensor:
    """Apply beamformer weights: y = wᴴ x over the element axis
    (beamformer.rs). snapshots (M, ...) with the elements first, as the
    reference's (M, T); weights (..., M), so stacked beams (B, M) give
    (B, ...) in one matrix product."""
    x = to_tensor(snapshots, IQ_DTYPE)
    w = to_tensor(weights, IQ_DTYPE, device=x.device)
    y = torch.conj(w).reshape(-1, w.shape[-1]) @ x.reshape(x.shape[0], -1)
    return y.reshape(*w.shape[:-1], *x.shape[1:])


def ambiguity_function(pulse, max_doppler_bins: int = 64, oversample: int = 1) -> torch.Tensor:
    """|χ(τ, ν)|² ambiguity surface (ambiguity_function.rs): one batched
    FFT over Doppler-shifted copies."""
    p = to_tensor(pulse, IQ_DTYPE)
    n = p.shape[-1]
    dops = torch.arange(-max_doppler_bins // 2, max_doppler_bins // 2, device=p.device)
    t = torch.arange(n, dtype=REAL_DTYPE, device=p.device) / real_scalar(n, p.device)
    shifted = p[None, :] * cis(2 * math.pi * (dops[:, None] * t[None, :]))  # (D, N)
    nfft = 1 << (2 * n - 2).bit_length() if n > 1 else 1
    pf = torch.fft.fft(p, n=nfft)
    sf = torch.fft.fft(shifted, n=nfft, dim=-1)
    xc = torch.fft.ifft(sf * torch.conj(pf)[None, :], dim=-1)
    out = torch.fft.fftshift(xc, dim=-1)
    return out.real ** 2 + out.imag ** 2
