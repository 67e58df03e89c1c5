"""Pieces shared by the HF serial-tone modems (MIL-STD-188-110 and
STANAG 4285): the 8PSK points, index tables on a device, and the
searchsorted lerp of the probe equalisers. A module of its own, so that
neither modem imports the other and the factory registers them in the
reference's order."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _psk8_host() -> np.ndarray:
    ang = 2.0 * np.pi * np.arange(8) / 8.0
    return np.exp(1j * ang).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _psk8(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_psk8_host()).to(device)


def _index(table: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(table)).long().to(device)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of (xp, fp) at x, xp increasing, as ``jnp.interp``:
    fp[i-1] + (x - xp[i-1]) / (xp[i] - xp[i-1]) · (fp[i] - fp[i-1]) between
    anchors, fp[0] below the first and fp[-1] above the last. `fp` may have
    leading axes (..., A): each row is interpolated, as a vmap of the
    reference's would."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    f = fp[..., i - 1] + (x - xp[i - 1]) / (xp[i] - xp[i - 1]) * (fp[..., i] - fp[..., i - 1])
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)
