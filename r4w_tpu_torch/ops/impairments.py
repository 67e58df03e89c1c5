"""Hardware impairment models on tensors.

PyTorch counterpart of ``r4w_tpu.ops.impairments``: Wiener phase noise,
static IQ imbalance with its blind estimate and correction, DC offset, the
Saleh and Rapp power-amplifier nonlinearities and uniform DAC
quantisation, each over (..., N) complex64 blocks on the last axis.
`phase_noise` takes ``key=`` (the reference's own threefry draws) or
``generator=`` (Philox), as `channel.channel` describes. Scalar
parameters are rounded to float32 on the host as the reference rounds
them.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.channel.channel import normal
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor


def phase_noise(x, linewidth_hz, sample_rate, *, key=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Wiener phase noise: a random-walk phase with variance
    2π·linewidth/fs per sample, the walk a float32 cumulative sum."""
    x = to_tensor(x, IQ_DTYPE)
    std = float(np.sqrt(np.float32(2.0 * np.pi * linewidth_hz / sample_rate)))
    steps = normal(x.shape, key=key, generator=generator, device=x.device) * std
    return x * cis(torch.cumsum(steps, dim=-1))


def iq_imbalance(x, gain_db=0.5, phase_deg=2.0) -> torch.Tensor:
    """Static gain/phase IQ imbalance: I' = g·I, Q' = Q·cos φ + I·sin φ."""
    x = to_tensor(x, IQ_DTYPE)
    g = 10.0 ** (real_scalar(gain_db, x.device) / 20.0)
    phi = real_scalar(phase_deg, x.device) * float(np.float32(np.pi / 180))
    return torch.complex(g * x.real, x.imag * torch.cos(phi) + x.real * torch.sin(phi))


def iq_imbalance_estimate(x) -> tuple[torch.Tensor, torch.Tensor]:
    """Blind (gain, phase) estimate: gain = √(E[I²]/E[Q²]), phase from E[I·Q]."""
    x = to_tensor(x, IQ_DTYPE)
    pi = torch.mean(x.real ** 2, dim=-1)
    pq = torch.mean(x.imag ** 2, dim=-1)
    cross = torch.mean(x.real * x.imag, dim=-1)
    gain = torch.sqrt(pi / torch.clamp(pq, min=1e-12))
    phase = torch.arcsin(torch.clamp(cross / torch.sqrt(torch.clamp(pi * pq, min=1e-24)),
                                     -1.0, 1.0))
    return gain, phase


def iq_imbalance_correct(x, gain, phase) -> torch.Tensor:
    """Invert `iq_imbalance` given (gain, phase) estimates."""
    x = to_tensor(x, IQ_DTYPE)
    gain = to_tensor(gain, REAL_DTYPE, x.device)
    phase = to_tensor(phase, REAL_DTYPE, x.device)
    i = x.real / gain
    return torch.complex(i, (x.imag - i * torch.sin(phase)) / torch.cos(phase))


def dc_offset(x, offset_i=0.0, offset_q=0.0) -> torch.Tensor:
    """Additive DC."""
    return to_tensor(x, IQ_DTYPE) + complex(np.float32(offset_i), np.float32(offset_q))


def saleh_pa(x, alpha_a=2.1587, beta_a=1.1517, alpha_p=4.0033, beta_p=9.1040) -> torch.Tensor:
    """Saleh TWT/SSPA nonlinearity: AM/AM = αa·r/(1+βa·r²), AM/PM = αp·r²/(1+βp·r²)."""
    x = to_tensor(x, IQ_DTYPE)
    r2 = torch.abs(x) ** 2
    gain = real_scalar(alpha_a, x.device) / (1.0 + float(np.float32(beta_a)) * r2)
    pm = float(np.float32(alpha_p)) * r2 / (1.0 + float(np.float32(beta_p)) * r2)
    return x * gain * cis(pm)


def rapp_pa(x, saturation=1.0, smoothness=2.0) -> torch.Tensor:
    """Rapp SSPA model: amplitude-only soft clipping."""
    x = to_tensor(x, IQ_DTYPE)
    r = torch.abs(x)
    p = 2 * smoothness
    g = 1.0 / (1.0 + (r / real_scalar(saturation, x.device)) ** p) ** (1.0 / p)
    return x * g


def quantize_dac(x, bits: int = 12, full_scale: float = 1.0) -> torch.Tensor:
    """Uniform DAC quantisation to 2^bits levels over ±full_scale, rounding
    half to even."""
    x = to_tensor(x, IQ_DTYPE)
    levels = 2 ** (bits - 1)
    step = real_scalar(full_scale / levels, x.device)

    def q(v):
        return torch.clamp(torch.round(v / step), -levels, levels - 1) * step

    return torch.complex(q(x.real), q(x.imag))
