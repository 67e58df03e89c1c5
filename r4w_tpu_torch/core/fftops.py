"""Batched FFT utilities.

PyTorch counterpart of ``r4w_tpu.core.fftops``: every helper works on the
last axis (or the one named), so leading batch axes (symbols, Monte-Carlo
lanes, PRNs, Doppler bins) ride along. Transforms are cuFFT on a CUDA
tensor. Functions follow the device of a tensor input; other inputs go to
`resolve_device(device)`.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor
from r4w_tpu_torch.core.windows import make_window


def fft(x, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """Forward FFT."""
    return torch.fft.fft(to_tensor(x).to(IQ_DTYPE), n=n, dim=axis)


def ifft(x, n: int | None = None, axis: int = -1) -> torch.Tensor:
    """Inverse FFT, normalised by 1/N."""
    return torch.fft.ifft(to_tensor(x).to(IQ_DTYPE), n=n, dim=axis)


def fftshift(x, axis: int = -1) -> torch.Tensor:
    """Centre DC."""
    return torch.fft.fftshift(to_tensor(x), dim=axis)


def power_spectrum(x, axis: int = -1) -> torch.Tensor:
    """|FFT|²."""
    spec = fft(x, axis=axis)
    return (spec.real ** 2 + spec.imag ** 2).to(REAL_DTYPE)


def magnitude(x) -> torch.Tensor:
    return torch.abs(to_tensor(x)).to(REAL_DTYPE)


def find_peak(spectrum, axis: int = -1):
    """Peak bin, magnitude and phase of a complex spectrum, batched over the
    leading axes: (bin_index int32, magnitude f32, phase f32)."""
    spectrum = to_tensor(spectrum)
    idx = torch.argmax(torch.abs(spectrum), dim=axis, keepdim=True)
    peak = torch.take_along_dim(spectrum, idx, dim=axis).squeeze(axis)
    return (idx.squeeze(axis).to(torch.int32), torch.abs(peak).to(REAL_DTYPE),
            torch.angle(peak).to(REAL_DTYPE))


def find_peak_interpolated(spectrum, axis: int = -1):
    """Quadratic (parabolic) peak interpolation on |spectrum|.

    Fits a parabola through the peak bin and its circular neighbours and
    returns (fractional_index f32, interpolated_magnitude f32).
    """
    mag = torch.movedim(torch.abs(to_tensor(spectrum)), axis, -1)
    n = mag.shape[-1]
    idx = torch.argmax(mag, dim=-1, keepdim=True)

    def at(i):
        return torch.take_along_dim(mag, torch.remainder(i, n), dim=-1)[..., 0]

    ym, y0, yp = at(idx - 1), at(idx), at(idx + 1)
    denom = ym - 2.0 * y0 + yp
    # delta in [-0.5, 0.5]; guard flat spectra
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    y_interp = y0 - 0.25 * (ym - yp) * delta
    return (idx[..., 0].to(REAL_DTYPE) + delta).to(REAL_DTYPE), y_interp.to(REAL_DTYPE)


def cross_correlate(a, b) -> torch.Tensor:
    """Circular cross-correlation IFFT(FFT(a)·conj(FFT(b))) at the power of
    two at or above len(a) + len(b) - 1, truncated to that length."""
    a, b = to_tensor(a).to(IQ_DTYPE), to_tensor(b).to(IQ_DTYPE)
    la, lb = a.shape[-1], b.shape[-1]
    n = 1 << (la + lb - 2).bit_length() if (la + lb - 1) > 1 else 1
    fa = torch.fft.fft(a, n=n, dim=-1)
    fb = torch.fft.fft(b, n=n, dim=-1)
    return torch.fft.ifft(fa * torch.conj(fb), dim=-1)[..., : la + lb - 1]


def spectrogram(x, nfft: int = 256, hop: int | None = None,
                window: str = "hann") -> torch.Tensor:
    """Magnitude spectrogram |S| of shape (..., n_frames, nfft): frames of
    the last axis at `hop` (default nfft // 2), windowed, transformed."""
    x = to_tensor(x)
    hop = hop or nfft // 2
    n_frames = max(0, (x.shape[-1] - nfft) // hop + 1)
    if n_frames == 0:
        return torch.zeros((*x.shape[:-1], 0, nfft), dtype=REAL_DTYPE, device=x.device)
    frames = x[..., : (n_frames - 1) * hop + nfft].unfold(-1, nfft, hop)
    w = make_window(window, nfft, x.device)
    return torch.abs(torch.fft.fft(frames * w, dim=-1)).to(REAL_DTYPE)
