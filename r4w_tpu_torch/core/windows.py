"""Window functions.

PyTorch counterpart of ``r4w_tpu.core.windows``. The windows are computed
in float64 numpy by the same formulas (`_np_window` is a copy of the
reference's), so designs built on them equal the JAX package's bit for
bit; `make_window` hands one over as a float32 tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, resolve_device


def _np_window(kind: str, n: int, **kw) -> np.ndarray:
    if n <= 0:
        return np.zeros(0)
    if n == 1:
        return np.ones(1)
    t = np.arange(n)
    if kind in ("rect", "rectangular", "boxcar", "none"):
        return np.ones(n)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * t / (n - 1))
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * t / (n - 1))
    if kind == "blackman":
        return (
            0.42
            - 0.5 * np.cos(2 * np.pi * t / (n - 1))
            + 0.08 * np.cos(4 * np.pi * t / (n - 1))
        )
    if kind == "blackmanharris":
        a = (0.35875, 0.48829, 0.14128, 0.01168)
        x = 2 * np.pi * t / (n - 1)
        return a[0] - a[1] * np.cos(x) + a[2] * np.cos(2 * x) - a[3] * np.cos(3 * x)
    if kind == "bartlett":
        return 1.0 - np.abs((t - (n - 1) / 2) / ((n - 1) / 2))
    if kind == "flattop":
        a = (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368)
        x = 2 * np.pi * t / (n - 1)
        return (
            a[0]
            - a[1] * np.cos(x)
            + a[2] * np.cos(2 * x)
            - a[3] * np.cos(3 * x)
            + a[4] * np.cos(4 * x)
        )
    if kind == "kaiser":
        beta = kw.get("beta", 8.6)
        return np.kaiser(n, beta)
    if kind == "gaussian":
        sigma = kw.get("sigma", 0.4)
        return np.exp(-0.5 * ((t - (n - 1) / 2) / (sigma * (n - 1) / 2)) ** 2)
    raise ValueError(f"unknown window: {kind}")


def make_window(kind: str, n: int, device=None, **kw) -> torch.Tensor:
    """A window of length n as a float32 tensor on `resolve_device(device)`."""
    return torch.as_tensor(_np_window(kind, n, **kw), dtype=REAL_DTYPE,
                           device=resolve_device(device))


def window_gains(kind: str, n: int, **kw) -> tuple[float, float]:
    """(coherent_gain, noise_equivalent_bandwidth) for PSD scaling."""
    w = _np_window(kind, n, **kw)
    cg = float(w.sum() / n)
    enbw = float(n * (w**2).sum() / (w.sum() ** 2))
    return cg, enbw
