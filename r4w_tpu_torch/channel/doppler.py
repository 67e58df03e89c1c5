"""Doppler fading generators on tensors.

PyTorch counterpart of ``r4w_tpu.channel.doppler``: Jakes
sum-of-sinusoids, flat and Gaussian-spectrum Doppler processes, each a
closed-form series over the whole block, one (M × N) outer product for
M oscillators. Random processes take ``key=`` (a `channel.threefry` key:
the reference's own draws, made on the host and moved to `device`) or
``generator=`` (Philox on its device), as `channel.channel` describes.
The series land on `device`, by default the generator's device or else
the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.channel.channel import TWO_PI, check_source, draw_device, normal, uniform
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import REAL_DTYPE, real_scalar, resolve_device

LIGHT_SPEED = 299_792_458.0


def velocity_to_doppler(velocity_mps, carrier_hz):
    """Max Doppler shift for a given speed."""
    return velocity_mps * carrier_hz / LIGHT_SPEED


def _times(n_samples: int, sample_rate, device) -> torch.Tensor:
    """t = n / fs, float32 division as the reference's."""
    return (torch.arange(n_samples, dtype=REAL_DTYPE, device=device)
            / real_scalar(sample_rate, device))


def _sum_of_cosines(arg: torch.Tensor, phi_i: torch.Tensor, phi_q: torch.Tensor,
                    m: int) -> torch.Tensor:
    """complex(Σ cos(arg + φ_i), Σ cos(arg + φ_q)) / √M over the oscillator axis."""
    i = torch.sum(torch.cos(arg + phi_i[:, None]), dim=0)
    q = torch.sum(torch.cos(arg + phi_q[:, None]), dim=0)
    return torch.complex(i, q) / float(np.sqrt(np.float32(m)))


def jakes_fading(n_samples: int, doppler_hz, sample_rate, n_oscillators: int = 16, *,
                 key=None, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """Jakes sum-of-sinusoids complex fading gain h[n], (n_samples,)
    complex64 with E[|h|²] ≈ 1. The M arrival angles are uniform around the
    circle with a random rotation and random phases. With a key: three
    split keys, for the rotation and the two phase sets."""
    check_source(key, generator)
    device = draw_device(generator, device)
    keys = threefry.split(key, 3) if key is not None else (None,) * 3
    m = n_oscillators
    draw = dict(generator=generator, device=device)
    alpha = ((torch.arange(m, dtype=REAL_DTYPE, device=device)
              + uniform((m,), key=keys[0], **draw)) * float(np.float32(2.0 * np.pi / m)))
    phi_i = uniform((m,), 0.0, 2.0 * np.pi, key=keys[1], **draw)
    phi_q = uniform((m,), 0.0, 2.0 * np.pi, key=keys[2], **draw)
    w = float(np.float32(2.0 * np.pi * doppler_hz)) * torch.cos(alpha)
    arg = w[:, None] * _times(n_samples, sample_rate, device)[None, :]
    return _sum_of_cosines(arg, phi_i, phi_q, m)


def flat_doppler_shift(n_samples: int, doppler_hz, sample_rate, device=None) -> torch.Tensor:
    """A pure frequency shift e^{j2π f_d t}, (n_samples,) complex64."""
    t = _times(n_samples, sample_rate, resolve_device(device))
    return cis(float(np.float32(2.0 * np.pi * doppler_hz)) * t)


def gaussian_doppler_fading(n_samples: int, doppler_std_hz, sample_rate,
                            n_oscillators: int = 16, *, key=None,
                            generator: torch.Generator | None = None,
                            device=None) -> torch.Tensor:
    """Gaussian Doppler-spectrum fading: a sum of sinusoids with normally
    distributed frequencies. With a key: three split keys, for the
    frequencies and the two phase sets."""
    check_source(key, generator)
    device = draw_device(generator, device)
    keys = threefry.split(key, 3) if key is not None else (None,) * 3
    m = n_oscillators
    draw = dict(generator=generator, device=device)
    freqs = normal((m,), key=keys[0], **draw) * float(np.float32(doppler_std_hz))
    phi_i = uniform((m,), 0.0, 2.0 * np.pi, key=keys[1], **draw)
    phi_q = uniform((m,), 0.0, 2.0 * np.pi, key=keys[2], **draw)
    arg = (TWO_PI * freqs)[:, None] * _times(n_samples, sample_rate, device)[None, :]
    return _sum_of_cosines(arg, phi_i, phi_q, m)
