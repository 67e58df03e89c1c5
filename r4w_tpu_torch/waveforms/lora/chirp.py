"""LoRa chirp synthesis, batch-first.

PyTorch counterpart of ``r4w_tpu.waveforms.lora.chirp``. The base up and
down chirps are computed once in float64 numpy, cast to complex64 and
cached per ``(sf, bw, oversample, device)``. A bank of symbol chirps is
one gather: symbol s is the base upchirp rotated by s·osf samples (the
wrap phase exp(j·2π·s) is 1 for an integer symbol, so rotation is exact).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, SYMBOL_DTYPE, resolve_device, to_tensor
from r4w_tpu_torch.waveforms.lora.params import LoRaParams


@functools.lru_cache(maxsize=None)
def _base_chirps_np(sf: int, bw_hz: int, oversample: int):
    """(upchirp, downchirp) as numpy complex64, length 2^sf * osf."""
    chips = 1 << sf
    n = chips * oversample
    ts = 1.0 / (bw_hz * oversample)
    t_symbol = chips / bw_hz
    df = bw_hz / t_symbol
    t = np.arange(n, dtype=np.float64) * ts
    # phase = 2π (f_init t ± df/2 t²), f_init = ∓bw/2
    up_phase = 2.0 * np.pi * (-bw_hz / 2.0 * t + df / 2.0 * t * t)
    up = np.exp(1j * up_phase).astype(np.complex64)
    down_phase = 2.0 * np.pi * (bw_hz / 2.0 * t - df / 2.0 * t * t)
    down = np.exp(1j * down_phase).astype(np.complex64)
    return up, down


@functools.lru_cache(maxsize=None)
def _base_chirps(sf: int, bw_hz: int, oversample: int, device: torch.device):
    """`_base_chirps_np` as read-only complex64 tensors on `device`."""
    up, down = _base_chirps_np(sf, bw_hz, oversample)
    return torch.from_numpy(up).to(device), torch.from_numpy(down).to(device)


def _chirps(params: LoRaParams, device) -> tuple[torch.Tensor, torch.Tensor]:
    return _base_chirps(params.sf, params.bw_hz, params.oversample,
                        resolve_device(device))


def base_upchirp(params: LoRaParams, device=None) -> torch.Tensor:
    return _chirps(params, device)[0]


def base_downchirp(params: LoRaParams, device=None) -> torch.Tensor:
    return _chirps(params, device)[1]


def symbol_chirps(params: LoRaParams, symbols) -> torch.Tensor:
    """Chirps for a batch of symbols: (..., S) int32 -> (..., S, N) complex64.

    out[s, i] = base_up[(i + symbol[s]*osf) % N], on the symbols' device.
    """
    n = params.samples_per_symbol
    syms = to_tensor(symbols, SYMBOL_DTYPE)
    shift = (syms.long() * params.oversample) % n
    idx = (torch.arange(n, device=syms.device) + shift[..., None]) % n
    return base_upchirp(params, syms.device)[idx]


def preamble(params: LoRaParams, device=None) -> torch.Tensor:
    """Preamble: P upchirps, 2 sync chirps (K-8, K-16), 2.25 downchirps."""
    up, down = _chirps(params, device)
    n = params.samples_per_symbol
    k = params.chips_per_symbol
    sync_syms = torch.tensor([max(k - 8, 0), max(k - 16, 0)],
                             dtype=SYMBOL_DTYPE, device=up.device)
    sync = symbol_chirps(params, sync_syms)
    parts = [up.repeat(params.preamble_length), sync.reshape(-1), down, down,
             down[: n // 4]]
    return torch.cat(parts).to(IQ_DTYPE)


def instantaneous_frequency(params: LoRaParams, samples: torch.Tensor) -> torch.Tensor:
    """Discrete instantaneous frequency in Hz."""
    phase = torch.angle(samples)
    dphase = torch.diff(phase)
    dphase = torch.remainder(dphase + math.pi, 2 * math.pi) - math.pi
    return dphase * params.sample_rate / (2.0 * math.pi)
