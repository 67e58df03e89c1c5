"""Adaptive and estimation filters: Wiener, Savitzky-Golay, lattice, comb,
adaptive notch, LMS, RLS, the memory polynomial and the FFT filter.

PyTorch counterpart of ``r4w_tpu.ops.adaptive`` (wiener_filter.rs,
savitzky_golay.rs, lattice_filter.rs, comb_filter.rs, adaptive_notch.rs,
volterra_filter.rs, lms_filter.rs, adaptive_filter_rls.rs,
filters/adaptive.rs, fft_filter.rs). Samples are on the last axis.

The block algorithms are vectorised: the Wiener gain and the FFT filter
are batched cuFFT calls, the Savitzky-Golay smoother and the FIR comb run
through `filters.fir_apply` (the FIR kernel on the card), the memory
polynomial is a gather and an einsum. The IIR comb's delay-K feedback is K
independent one-pole recursions: its polyphase lanes are the rows of one
launch of the recursion kernel (kind ``linear``). LMS, RLS, the lattice
and the adaptive notch stay step loops over the samples, as the
reference's ``lax.scan``s are. `identify_memory_polynomial` solves its
least squares with ``torch.linalg.lstsq`` (QR on the CPU and the card),
and `am_am_curve` sums its bins by a one-hot product, never a scatter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import complex_abs, linspace
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.kernels.recurrence import first_order_recurrence_dispatch
from r4w_tpu_torch.ops.filters import fir_apply


def _pad_front(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.cat([x.new_zeros(x.shape[:-1] + (k,)), x], dim=-1)


# ------------------------------------------------------------- Wiener


def wiener_filter(x, noise_power: float, nfft: int = 256):
    """Block frequency-domain Wiener denoiser (wiener_filter.rs): each
    segment's gain max(Sxx − N0, 0)/Sxx from its own periodogram, no
    overlap; a tail shorter than nfft passes through."""
    x = to_tensor(x, IQ_DTYPE)
    nseg = x.shape[-1] // nfft
    segs = x[..., : nseg * nfft].reshape(*x.shape[:-1], nseg, nfft)
    spec = torch.fft.fft(segs, dim=-1)
    pxx = complex_abs(spec) ** 2 / nfft
    gain = torch.clamp(pxx - noise_power, min=0.0) / torch.clamp(pxx, min=1e-30)
    y = torch.fft.ifft(spec * gain, dim=-1).reshape(*x.shape[:-1], nseg * nfft)
    return torch.cat([y, x[..., nseg * nfft:]], dim=-1)


# ------------------------------------------------------- Savitzky-Golay


def savitzky_golay_taps(window: int, polyorder: int, deriv: int = 0) -> np.ndarray:
    """Least-squares polynomial smoothing taps (savitzky_golay.rs design),
    numpy float64 in convolution order."""
    if window % 2 == 0 or window < 1:
        raise ValueError("window must be odd and positive")
    if polyorder >= window:
        raise ValueError("polyorder must be < window")
    half = window // 2
    a = np.vander(np.arange(-half, half + 1, dtype=np.float64), polyorder + 1, increasing=True)
    taps = np.linalg.pinv(a)[deriv] * math.factorial(deriv)
    return taps[::-1].copy()


def savgol_smooth(x, window: int = 11, polyorder: int = 3):
    """Same-length Savitzky-Golay smoothing; the edge samples pass
    through."""
    x = to_tensor(x)
    half = window // 2
    y = fir_apply(savitzky_golay_taps(window, polyorder).astype(np.float32), x)
    # the streaming FIR's centred output for x[n] sits at y[n + half]
    return torch.cat([x[..., :half], y[..., 2 * half:], x[..., -half:]], dim=-1)


# ------------------------------------------------------------- lattice


def lattice_filter(reflection, x):
    """All-zero (FIR) lattice with reflection coefficients k (M,)
    (lattice_filter.rs forward path): the order-M forward prediction error.
    A step loop over the samples, each step the M stages in turn."""
    x = to_tensor(x, REAL_DTYPE)
    k = to_tensor(np.asarray(reflection, np.float32), REAL_DTYPE, device=x.device)
    m = k.shape[0]
    b_prev = [x.new_zeros(x.shape[:-1]) for _ in range(m)]
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        f = x[..., t]
        b_outs = []
        for s in range(m):
            b_outs.append(b_prev[s] + k[s] * f)
            f = f + k[s] * b_prev[s]
        y[..., t] = f
        # stage s at time t + 1 reads the backward error of stage s - 1 at t
        b_prev = [x[..., t]] + b_outs[:-1]
    return y


def lattice_from_lpc(a) -> np.ndarray:
    """LPC polynomial (1, a1..aM) -> reflection coefficients by the reverse
    Levinson recursion (lattice_filter.rs design helper)."""
    a = np.asarray(a, np.float64)
    if a[0] != 1.0:
        a = a / a[0]
    coeffs = a[1:].copy()
    m = len(coeffs)
    k = np.zeros(m)
    for i in range(m - 1, -1, -1):
        k[i] = coeffs[i]
        if i > 0:
            denom = 1.0 - k[i] ** 2
            coeffs = (coeffs[:i] - k[i] * coeffs[i - 1::-1]) / denom
    return k


# ---------------------------------------------------------------- comb


def comb_feedforward(x, delay: int, alpha: float = -1.0):
    """FIR comb y[n] = x[n] + α·x[n−K]: nulls at odd (α = −1) or between
    (α = +1) multiples of fs/K (comb_filter.rs)."""
    x = to_tensor(x)
    return x + alpha * _pad_front(x[..., :-delay], delay)


def comb_feedback(x, delay: int, alpha: float = 0.8):
    """IIR comb y[n] = x[n] + α·y[n−K] (fma(α, y[n−K], x[n])): a resonator
    at multiples of fs/K, its K polyphase lanes the rows of one recursion
    launch."""
    x = to_tensor(x)
    n, k = x.shape[-1], delay
    xp = torch.cat([x, x.new_zeros(x.shape[:-1] + ((-n) % k,))], dim=-1)
    lanes = xp.reshape(*x.shape[:-1], -1, k).transpose(-1, -2)  # (..., K, M)
    y = first_order_recurrence_dispatch(lanes.contiguous(), "linear", alpha)
    return y.transpose(-1, -2).reshape(xp.shape)[..., :n]


# ------------------------------------------------------- adaptive notch


def adaptive_notch(x, num_taps: int = 32, mu: float = 0.02, delay: int = 1):
    """Remove narrowband interferers of unknown frequency with an adaptive
    line enhancer (adaptive_notch.rs role): LMS predicts x[n] from
    x[n−delay...]; the prediction holds the tones, the error the notched
    broadband residual. Returns (residual, narrowband estimate)."""
    x = to_tensor(x, IQ_DTYPE)
    y, e, _ = lms_filter(_pad_front(x[..., :-delay], delay), x, num_taps, mu)
    return e, y


# --------------------------------------------------------------- LMS/RLS


def _adaptive_inputs(x, desired):
    x = to_tensor(x)
    d = to_tensor(desired, device=x.device)
    dt = IQ_DTYPE if (x.is_complex() or d.is_complex()) else REAL_DTYPE
    return x.to(dt), d.to(dt), dt


def lms_filter(x, desired, num_taps: int, mu: float = 0.01):
    """Normalised LMS system identification (lms_filter.rs): adapt w so that
    wᴴu tracks `desired`. Returns (y, err, final weights). A step loop."""
    x, d, dt = _adaptive_inputs(x, desired)
    w = torch.zeros(num_taps, dtype=dt, device=x.device)
    buf = torch.zeros_like(w)
    y, e = torch.empty_like(x), torch.empty_like(x)
    for t in range(x.shape[-1]):
        buf = torch.cat([x[t:t + 1], buf[:-1]])
        yt = torch.sum(torch.conj(w) * buf)
        et = d[t] - yt
        w = w + mu * torch.conj(et) * buf / (1e-9 + torch.sum(torch.conj(buf) * buf).real)
        y[t], e[t] = yt, et
    return y, e, w


def rls_filter(x, desired, num_taps: int, lam: float = 0.99, delta: float = 100.0):
    """Recursive least squares adaptation (adaptive_filter_rls.rs). Returns
    (y, err, final weights). A step loop."""
    x, d, dt = _adaptive_inputs(x, desired)
    w = torch.zeros(num_taps, dtype=dt, device=x.device)
    p = delta * torch.eye(num_taps, dtype=dt, device=x.device)
    buf = torch.zeros_like(w)
    y, e = torch.empty_like(x), torch.empty_like(x)
    for t in range(x.shape[-1]):
        buf = torch.cat([x[t:t + 1], buf[:-1]])
        pi = p @ buf
        k = pi / (lam + torch.sum(torch.conj(buf) * pi).real)
        yt = torch.sum(torch.conj(w) * buf)
        et = d[t] - yt
        w = w + k * torch.conj(et)
        p = (p - torch.outer(k, torch.conj(buf)) @ p) / lam
        y[t], e[t] = yt, et
    return y, e, w


# ------------------------------------------------- Volterra / DPD


def _delay_frames(x: torch.Tensor, m: int) -> torch.Tensor:
    """(..., N, M): x[n − j] at [n, j], zeros before the start."""
    return _pad_front(x, m - 1).unfold(-1, m, 1).flip(-1)


def memory_polynomial_apply(coeffs, x, orders=(1, 3, 5)):
    """Diagonal-Volterra memory polynomial PA/DPD model
    (volterra_filter.rs MemoryPolynomial::process):
    y[n] = Σ_k Σ_m c[k, m]·x[n−m]·|x[n−m]|^(order_k − 1)."""
    x = to_tensor(x, IQ_DTYPE)
    c = to_tensor(coeffs, IQ_DTYPE, device=x.device)
    korders = torch.tensor(orders, dtype=REAL_DTYPE, device=x.device)
    frames = _delay_frames(x, c.shape[1])
    env = complex_abs(frames)
    basis = frames[..., None, :] * (env[..., None, :] ** (korders[:, None] - 1.0))
    return torch.einsum("...nkm,km->...n", basis, c)


def identify_memory_polynomial(x, y, memory: int = 3, orders=(1, 3, 5)):
    """Least-squares PA model extraction (volterra_filter.rs:508): the
    (K, M) coefficients by ``torch.linalg.lstsq`` (QR, `gels`, which the
    CPU and the card share)."""
    x = to_tensor(x, IQ_DTYPE).reshape(-1)
    y = to_tensor(y, IQ_DTYPE, device=x.device).reshape(-1)
    frames = _delay_frames(x, memory)
    env = complex_abs(frames)
    a = torch.cat([frames * env ** (float(k) - 1.0) for k in orders], dim=1)  # (N, K·M)
    sol = torch.linalg.lstsq(a, y[:, None], driver="gels").solution[:, 0]
    return sol.reshape(len(orders), memory)


def nmse_db(reference, test) -> torch.Tensor:
    """Normalised mean-square error in dB (volterra_filter.rs:634)."""
    r = to_tensor(reference).reshape(-1)
    t = to_tensor(test, device=r.device).reshape(-1)
    num = torch.sum(torch.abs(t - r) ** 2)
    den = torch.clamp(torch.sum(torch.abs(r) ** 2), min=1e-30)
    return 10.0 * torch.log10(torch.clamp(num / den, min=1e-30))


def am_am_curve(x, y, num_bins: int = 32):
    """Mean output amplitude against input amplitude in `num_bins` equal
    bins (volterra_filter.rs:694). Returns (bin centres, means)."""
    xin = torch.abs(to_tensor(x).reshape(-1)).to(REAL_DTYPE)
    yout = torch.abs(to_tensor(y, device=xin.device).reshape(-1)).to(REAL_DTYPE)
    edges = linspace(0.0, torch.max(xin) + 1e-9, num_bins + 1)
    which = torch.clamp(torch.searchsorted(edges, xin) - 1, 0, num_bins - 1)
    onehot = (which[:, None] == torch.arange(num_bins, device=xin.device)).to(REAL_DTYPE)
    sums = torch.sum(onehot * yout[:, None], dim=0)
    cnts = torch.sum(onehot, dim=0)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, sums / torch.clamp(cnts, min=1.0)


# ------------------------------------------------------ overlap-save


def fft_filter(taps, x, nfft: int | None = None):
    """Overlap-save fast convolution (fft_filter.rs): the streaming FIR's
    same length with zero initial state, every block in one batched
    transform."""
    x = to_tensor(x)
    taps = to_tensor(taps, device=x.device)
    cplx = x.is_complex() or taps.is_complex()
    k, n = taps.shape[0], x.shape[-1]
    if nfft is None:
        nfft = max(64, 1 << int(np.ceil(np.log2(4 * k))))
    hop = nfft - (k - 1)
    nblocks = -(-n // hop)
    xp = torch.cat([x.new_zeros(x.shape[:-1] + (k - 1,)), x,
                    x.new_zeros(x.shape[:-1] + (nblocks * hop - n,))], dim=-1)
    blocks = xp.unfold(-1, nfft, hop)[..., :nblocks, :]  # (..., B, nfft)
    hf = torch.fft.fft(taps.to(IQ_DTYPE), nfft)
    yb = torch.fft.ifft(torch.fft.fft(blocks.to(IQ_DTYPE), dim=-1) * hf, dim=-1)[..., k - 1:]
    y = yb.reshape(*x.shape[:-1], nblocks * hop)[..., :n]
    return y if cplx else y.real.contiguous()
