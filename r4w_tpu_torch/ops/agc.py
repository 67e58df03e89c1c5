"""AGC and assorted transform blocks: CORDIC, chirp-Z, cyclostationary
detector, Wigner-Ville.

PyTorch counterpart of ``r4w_tpu.ops.agc`` (agc.rs:33-60, cordic.rs,
chirp_z_transform.rs, cyclostationary_detector.rs,
wigner_ville_distribution.rs). The AGC is a step loop over the samples
whose gain stays a tensor on the samples' device (leading axes are a
batch of independent loops); the rest is batched. The chirp-Z chirps are
built on the host in complex128 and cast to complex64, as the reference
builds them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.measure import stft


def agc(x, target_level: float = 1.0, attack: float = 0.01,
        decay: float = 0.001, gain0: float = 1.0, max_gain: float = 1e4):
    """Automatic gain control (agc.rs): a per-sample gain recurrence —
    attack when too loud, decay-up when too quiet.

    Returns (y, final_gain, gain_series).
    """
    x = to_tensor(x, IQ_DTYPE)
    gain = torch.full(x.shape[:-1], gain0, dtype=REAL_DTYPE, device=x.device)
    ys, gains = [], []
    for t in range(x.shape[-1]):
        y = x[..., t] * gain
        err = target_level - complex_abs(y)
        rate = torch.where(err < 0, attack, decay)
        gain = torch.clamp(gain * (1.0 + rate * err), 1e-6, max_gain)
        ys.append(y)
        gains.append(gain)
    if not ys:
        return x.new_zeros(x.shape), gain, torch.zeros(x.shape, dtype=REAL_DTYPE,
                                                       device=x.device)
    return torch.stack(ys, dim=-1), gain, torch.stack(gains, dim=-1)


def agc_block(x, target_level: float = 1.0, block: int = 256):
    """Feed-forward block AGC: one gain per block from the block RMS — the
    batch-first alternative to the per-sample loop."""
    x = to_tensor(x, IQ_DTYPE)
    nb = x.shape[-1] // block
    blocks = x[..., : nb * block].reshape(*x.shape[:-1], nb, block)
    rms = torch.sqrt(torch.mean(torch.abs(blocks) ** 2, dim=-1, keepdim=True))
    gain = real_scalar(target_level, x.device) / torch.clamp_min(rms, 1e-9)
    return (blocks * gain).reshape(*x.shape[:-1], nb * block)


def _cordic_constants(iterations: int) -> tuple[np.ndarray, float]:
    """(atan(2^-i) for each iteration, the gain correction Π 1/√(1 + 2^-2i))."""
    angles = np.arctan(2.0 ** -np.arange(iterations))
    k = float(np.prod(1.0 / np.sqrt(1 + 2.0 ** (-2.0 * np.arange(iterations)))))
    return angles, k


def cordic_rotate(x, y, angle_rad, iterations: int = 16):
    """CORDIC vector rotation (cordic.rs) — shift-add only, batched.

    Returns (x', y') ≈ (x·cosθ − y·sinθ, x·sinθ + y·cosθ).
    """
    x = to_tensor(x, REAL_DTYPE)
    y = to_tensor(y, REAL_DTYPE, x.device)
    z = to_tensor(angle_rad, REAL_DTYPE, x.device)
    # wrap into [-pi/2, pi/2] with quadrant correction
    flip = torch.abs(z) > math.pi / 2
    x = torch.where(flip, -x, x)
    y = torch.where(flip, -y, y)
    z = torch.where(z > math.pi / 2, z - math.pi,
                    torch.where(z < -math.pi / 2, z + math.pi, z))
    angles, k = _cordic_constants(iterations)
    for i in range(iterations):
        d = torch.where(z >= 0, 1.0, -1.0)
        x, y = x - d * y * 2.0 ** -i, y + d * x * 2.0 ** -i
        z = z - d * float(angles[i])
    return x * k, y * k


def cordic_magnitude_phase(i, q, iterations: int = 16):
    """Vectoring-mode CORDIC: (|v|, atan2(q, i)) via shift-add rotations
    (cordic.rs vectoring mode)."""
    x = to_tensor(i, REAL_DTYPE)
    y = to_tensor(q, REAL_DTYPE, x.device)
    # reflect the left half-plane onto the right; remember the offset
    neg = x < 0
    z = torch.where(neg, torch.where(y >= 0, math.pi, -math.pi), 0.0)
    x = torch.where(neg, -x, x)
    y = torch.where(neg, -y, y)
    angles, k = _cordic_constants(iterations)
    for it in range(iterations):
        d = torch.where(y >= 0, 1.0, -1.0)
        x, y = x + d * y * 2.0 ** -it, y - d * x * 2.0 ** -it
        z = z + d * float(angles[it])
    return x * k, z


def chirp_z_transform(x, m: int, w: complex, a: complex = 1.0 + 0j):
    """Chirp-Z transform (chirp_z_transform.rs): evaluate the z-transform
    on the spiral a·w^-k, k=0..M-1, via Bluestein's algorithm."""
    x = to_tensor(x, IQ_DTYPE)
    dev = x.device
    n = x.shape[-1]
    k2 = (np.arange(max(n, m)) ** 2) / 2.0
    wk = np.power(np.asarray(w, np.complex128), k2[:n])
    an = np.power(1.0 / np.asarray(a, np.complex128), np.arange(n))
    y = x * torch.from_numpy((an * wk).astype(np.complex64)).to(dev)
    nfft = 1
    while nfft < n + m - 1:
        nfft <<= 1
    v_np = np.zeros(nfft, np.complex128)
    wmk = np.power(np.asarray(w, np.complex128), -k2[: max(n, m)])
    v_np[:m] = wmk[:m]
    v_np[nfft - n + 1:] = wmk[1:n][::-1]
    v_f = torch.fft.fft(torch.from_numpy(v_np.astype(np.complex64)).to(dev))
    out = torch.fft.ifft(torch.fft.fft(y, n=nfft, dim=-1) * v_f, dim=-1)[..., :m]
    wm = np.power(np.asarray(w, np.complex128), k2[:m])
    return out * torch.from_numpy(wm.astype(np.complex64)).to(dev)


def zoom_fft(x, f_lo: float, f_hi: float, m: int, sample_rate: float):
    """Zoomed spectrum on [f_lo, f_hi) with m bins via chirp-Z."""
    a = np.exp(2j * np.pi * f_lo / sample_rate)
    w = np.exp(-2j * np.pi * (f_hi - f_lo) / (m * sample_rate))
    return chirp_z_transform(x, m, w, a)


def cyclostationary_detector(x, alpha_hz, sample_rate, nfft: int = 256):
    """Spectral correlation at cyclic frequency α (cyclostationary_
    detector.rs): correlate shifted spectra — detects cyclostationary
    signals (e.g. BPSK at symbol rate) buried in noise."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    t = torch.arange(n, dtype=REAL_DTYPE, device=x.device) / real_scalar(sample_rate, x.device)
    up = x * cis(math.pi * alpha_hz * t)
    dn = x * cis(-(math.pi * alpha_hz * t))
    s_up = stft(up, nfft)
    s_dn = stft(dn, nfft)
    scf = torch.mean(s_up * torch.conj(s_dn), dim=-2)
    p_up = torch.mean(torch.abs(s_up) ** 2, dim=-2)
    p_dn = torch.mean(torch.abs(s_dn) ** 2, dim=-2)
    return torch.abs(scf) / torch.sqrt(torch.clamp_min(p_up * p_dn, 1e-30))  # (..., nfft) in [0, 1]


def wigner_ville(x, nfft: int = 128):
    """Discrete pseudo-Wigner-Ville distribution
    (wigner_ville_distribution.rs): time-frequency energy surface (n, nfft)."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    half = nfft // 2
    pad = torch.nn.functional.pad(x, (half, half))
    taus = torch.arange(-half, half, device=x.device)
    # r[t, tau] = x[t+tau]·conj(x[t-tau])
    t_idx = torch.arange(n, device=x.device)[:, None] + half
    r = pad[t_idx + taus[None, :]] * torch.conj(pad[t_idx - taus[None, :]])
    return torch.real(torch.fft.fft(r, n=nfft, dim=-1))
