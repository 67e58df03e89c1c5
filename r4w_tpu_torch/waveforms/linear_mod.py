"""Shared machinery for memoryless linear modulations (PSK/QAM).

PyTorch counterpart of ``r4w_tpu.waveforms.linear_mod``. One batched path
serves every scheme:

  TX: bits → symbol values → Gray LUT → constellation gather → repeat sps
  RX: reshape (S, sps) → mean → nearest-constellation argmin → Gray⁻¹ LUT

The constellations and maps are numpy tables built on the host (copies of
the reference's); the nearest-point search is a plain (S × M) distance
and argmin. Functions follow the device of a tensor input; tables and
other inputs are moved to it.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE, to_tensor
from r4w_tpu_torch.ops.coding import bits_to_bytes, bits_to_symbols, symbols_to_bits

# 1-D Gray sequences used by the reference's PSK and QAM maps
GRAY_1D = {
    2: [0, 1],
    4: [0, 1, 3, 2],
    8: [0, 1, 3, 2, 6, 7, 5, 4],
    16: [0, 1, 3, 2, 6, 7, 5, 4, 12, 13, 15, 14, 10, 11, 9, 8],
}


def psk_constellation(m: int, amplitude: float = 1.0) -> np.ndarray:
    """PSK points: amp·e^{j(offset + 2πi/M)}, offset π/4 for QPSK."""
    offset = np.pi / 4.0 if m == 4 else 0.0
    ang = offset + 2.0 * np.pi * np.arange(m) / m
    return (amplitude * np.exp(1j * ang)).astype(np.complex64)


def psk_value_to_index(m: int) -> np.ndarray:
    """Map bit-group value -> constellation index (inverse of the PSK Gray map)."""
    gray_map = np.array(GRAY_1D.get(m, list(range(m))))
    inv = np.zeros(m, np.int32)
    inv[gray_map] = np.arange(m)
    return inv


def qam_constellation(order: int, amplitude: float = 1.0) -> np.ndarray:
    """Square QAM grid, unit average power."""
    side = int(round(np.sqrt(order)))
    i = (2.0 * np.arange(side) - (side - 1))[:, None]
    q = (2.0 * np.arange(side) - (side - 1))[None, :]
    pts = (i + 1j * q).reshape(-1)
    norm = np.sqrt(np.mean(np.abs(pts) ** 2))
    return (amplitude * pts / norm).astype(np.complex64)


def qam_value_to_index(order: int) -> np.ndarray:
    """map[gray_value] = grid index."""
    side = int(round(np.sqrt(order)))
    gray_1d = np.array(GRAY_1D.get(side, list(range(side))))
    out = np.zeros(order, np.int32)
    for idx, gi in enumerate(gray_1d):
        for jdx, gq in enumerate(gray_1d):
            out[gi * side + gq] = idx * side + jdx
    return out


def index_to_value(value_to_index: np.ndarray) -> np.ndarray:
    inv = np.zeros_like(value_to_index)
    inv[value_to_index] = np.arange(len(value_to_index), dtype=np.int32)
    return inv


# --------------------------------------------------------------------------
# Batched TX/RX cores
# --------------------------------------------------------------------------


def linear_modulate(bits, constellation, value_to_index, bits_per_symbol: int,
                    sps: int) -> torch.Tensor:
    """bits (..., B) -> IQ (..., (B/bps)·sps), B a multiple of bps (pre-pad)."""
    values = bits_to_symbols(bits, bits_per_symbol)
    idx = to_tensor(value_to_index, device=values.device).long()[values.long()]
    points = to_tensor(constellation, IQ_DTYPE, values.device)[idx]  # (..., S)
    return points.repeat_interleave(sps, dim=-1)


def linear_demodulate_symbols(samples, constellation, sps: int):
    """IQ (..., S·sps) -> (constellation indices (..., S), evm_rms, snr_db)."""
    samples = to_tensor(samples, IQ_DTYPE)
    s = samples.shape[-1] // sps
    chunks = samples[..., : s * sps].reshape(*samples.shape[:-1], s, sps)
    avg = torch.mean(chunks, dim=-1)  # (..., S)
    const = to_tensor(constellation, IQ_DTYPE, samples.device)
    d = avg[..., None] - const  # (..., S, M)
    dist = d.real ** 2 + d.imag ** 2
    idx = torch.argmin(dist, dim=-1).to(SYMBOL_DTYPE)
    err = avg - const[idx.long()]
    evm_rms = torch.sqrt(torch.mean(err.real ** 2 + err.imag ** 2, dim=-1))
    snr_db = -20.0 * torch.log10(torch.clamp_min(evm_rms, 1e-12))
    return idx, evm_rms.to(REAL_DTYPE), snr_db.to(REAL_DTYPE)


def indices_to_bits(idx, index_to_value_lut, bits_per_symbol: int) -> torch.Tensor:
    idx = to_tensor(idx)
    values = to_tensor(index_to_value_lut, device=idx.device).long()[idx.long()]
    return symbols_to_bits(values, bits_per_symbol)


def pack_demod_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pad a bit stream (..., n) to whole bytes and pack it MSB first."""
    rem = bits.shape[-1] % 8
    if rem:
        bits = torch.nn.functional.pad(bits, (0, 8 - rem))
    return bits_to_bytes(bits)


# --------------------------------------------------------------------------
# The PSK and QAM waveforms' shared modulate and demodulate
# --------------------------------------------------------------------------


def modulate_data(data, constellation: np.ndarray, value_to_index: np.ndarray,
                  bits_per_symbol: int, sps: int, device) -> torch.Tensor:
    """Bytes or a 0/1 bit vector -> IQ on `device`, the bits zero-padded to
    whole symbols."""
    from r4w_tpu_torch.waveforms.base import data_to_bits

    bits = data_to_bits(data)
    rem = bits.size % bits_per_symbol
    if rem:
        bits = np.pad(bits, (0, bits_per_symbol - rem))
    return linear_modulate(torch.from_numpy(bits).to(device), constellation, value_to_index,
                           bits_per_symbol, sps)


def demodulate_samples(samples, constellation: np.ndarray, value_to_index: np.ndarray,
                       bits_per_symbol: int, sps: int, device):
    """IQ -> DemodResult with packed bytes, constellation indices, the SNR
    estimate and `evm_rms`. A tensor is demodulated on its own device,
    anything else on `device`."""
    from r4w_tpu_torch.waveforms.base import DemodResult

    if not isinstance(samples, torch.Tensor):
        samples = to_tensor(samples, device=device)
    idx, evm, snr = linear_demodulate_symbols(samples, constellation, sps)
    bits = indices_to_bits(idx, index_to_value(value_to_index), bits_per_symbol)
    return DemodResult(bits=pack_demod_bits(bits), symbols=idx, snr_estimate=float(snr),
                       metadata={"evm_rms": float(evm)})
