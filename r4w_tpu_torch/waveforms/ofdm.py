"""OFDM modem.

PyTorch counterpart of ``r4w_tpu.waveforms.ofdm``. All OFDM symbols of a
packet go through one batched (n_sym, fft_size) transform with the
reference's unitary scaling written out (`ifft(...)·√N·amplitude`,
`fft(...)/(√N·amplitude)`). Subcarriers are allocated about a null DC
bin; with pilots (the default) the receiver estimates the channel from a
training symbol and tracks the common phase on the pilots
(`ops.ofdm`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, SYMBOL_DTYPE, CommonParams
from r4w_tpu_torch.ops import ofdm as ofdm_ops
from r4w_tpu_torch.ops.coding import bits_to_symbols, symbols_to_bits
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          data_to_bits, register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits


@functools.lru_cache(maxsize=None)
def subcarrier_constellation(scheme: str) -> np.ndarray:
    """LUT: bit-group value -> constellation point."""
    if scheme == "bpsk":
        return np.array([1.0, -1.0], np.complex64)
    if scheme == "qpsk":
        s = 1.0 / np.sqrt(2.0)
        pts = []
        for v in range(4):
            b0, b1 = (v >> 1) & 1, v & 1
            pts.append(complex(s if b0 == 0 else -s, s if b1 == 0 else -s))
        return np.array(pts, np.complex64)
    if scheme == "qam16":
        levels = np.array([-3.0, -1.0, 3.0, 1.0]) / np.sqrt(10.0)
        pts = [complex(levels[(v >> 2) & 0b11], levels[v & 0b11]) for v in range(16)]
        return np.array(pts, np.complex64)
    if scheme == "qam64":
        levels = np.array([-7.0, -5.0, -1.0, -3.0, 7.0, 5.0, 1.0, 3.0]) / np.sqrt(42.0)
        pts = [complex(levels[(v >> 3) & 0b111], levels[v & 0b111]) for v in range(64)]
        return np.array(pts, np.complex64)
    raise ValueError(f"unknown subcarrier scheme: {scheme}")


def constellation_tensor(scheme: str, device) -> torch.Tensor:
    return torch.from_numpy(subcarrier_constellation(scheme)).to(device)


def nearest_points(points: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """Index of the nearest constellation point (the first on ties)."""
    d = points[..., None] - const
    return torch.argmin(d.real ** 2 + d.imag ** 2, dim=-1).to(SYMBOL_DTYPE)


_BITS_PER_SC = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}


@dataclasses.dataclass(frozen=True)
class OFDM(Waveform):
    """With num_pilots > 0 (the default) each OFDM symbol carries known
    pilots spread across the occupied band, edges included, and a training
    symbol leads the packet; num_pilots=0 is the bare pilotless frame."""

    common: CommonParams = CommonParams()
    fft_size: int = 64
    num_data_subcarriers: int = 48
    cyclic_prefix_ratio: float = 0.25
    subcarrier_mod: str = "qpsk"
    num_pilots: int = 4
    num_training_symbols: int = 1
    equalizer: str = "mmse"  # "mmse" | "zf"
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    @property
    def num_occupied(self) -> int:
        return self.num_data_subcarriers + self.num_pilots

    @functools.cached_property
    def pilot_pattern(self):
        if self.num_pilots == 0:
            return None
        return ofdm_ops.PilotPattern.edges_and_uniform(self.num_occupied, self.num_pilots)

    @property
    def cp_len(self) -> int:
        return int(self.fft_size * self.cyclic_prefix_ratio)

    @property
    def bits_per_subcarrier(self) -> int:
        return _BITS_PER_SC[self.subcarrier_mod]

    @property
    def bits_per_ofdm_symbol(self) -> int:
        return self.num_data_subcarriers * self.bits_per_subcarrier

    def samples_per_symbol(self) -> int:
        return self.fft_size + self.cp_len

    @property
    def subcarrier_spacing(self) -> float:
        return self.common.sample_rate / self.fft_size

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="OFDM",
            full_name="Orthogonal Frequency Division Multiplexing",
            description="Multi-carrier modulation via FFT — WiFi/LTE/5G core",
            complexity=5,
            bits_per_symbol=min(self.bits_per_ofdm_symbol, 255),
            characteristics=("FFT/IFFT multi-carrier", "Cyclic prefix",
                             "Centered allocation, DC null"),
        )

    def _fft_bins(self) -> np.ndarray:
        """Occupied subcarrier -> FFT bin: centred allocation with a null DC
        bin, over data and pilot positions."""
        n = self.num_occupied
        half = n // 2
        idx = np.arange(n)
        return np.where(idx < half, self.fft_size - half + idx, idx - half + 1)

    def _index(self, values: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(values, np.int64)).to(self.device)

    def modulate(self, data) -> torch.Tensor:
        bits = data_to_bits(data)
        bpo = self.bits_per_ofdm_symbol
        rem = bits.size % bpo
        if rem:
            bits = np.pad(bits, (0, bpo - rem))
        n_sym = bits.size // bpo
        values = bits_to_symbols(torch.from_numpy(bits.reshape(n_sym, -1)).to(self.device),
                                 self.bits_per_subcarrier)  # (n_sym, n_sc)
        points = constellation_tensor(self.subcarrier_mod, self.device)[values.long()]
        pat = self.pilot_pattern
        if pat is None:
            occ = points
        else:
            occ = torch.zeros((n_sym, self.num_occupied), dtype=IQ_DTYPE, device=self.device)
            occ[:, self._index(pat.data_positions)] = points
            occ[:, self._index(pat.positions)] = torch.from_numpy(
                np.asarray(pat.values, np.complex64)).to(self.device)
            if self.num_training_symbols:
                train = np.tile(ofdm_ops.training_sequence(self.num_occupied),
                                (self.num_training_symbols, 1))
                occ = torch.cat([torch.from_numpy(train).to(self.device), occ], dim=0)
        freq = torch.zeros((occ.shape[0], self.fft_size), dtype=IQ_DTYPE, device=self.device)
        freq[:, self._index(self._fft_bins())] = occ
        scale = self.common.amplitude * float(np.sqrt(self.fft_size))
        time = torch.fft.ifft(freq, dim=-1) * scale
        cp = time[:, self.fft_size - self.cp_len:]
        sym = torch.cat([cp, time], dim=-1)  # (n_sym, cp + N)
        return sym.reshape(-1).to(IQ_DTYPE)

    def occupied_subcarriers(self, samples) -> torch.Tensor:
        """(..., S·(cp+N)) -> (..., S, n_occupied) raw post-FFT points."""
        samples = as_iq(samples, self.device)
        n = self.samples_per_symbol()
        s = samples.shape[-1] // n
        sym = samples[..., : s * n].reshape(*samples.shape[:-1], s, n)
        scale = torch.tensor(self.common.amplitude * float(np.sqrt(self.fft_size)),
                             dtype=torch.float32, device=samples.device)
        freq = torch.fft.fft(sym[..., self.cp_len:], dim=-1) / scale
        bins = torch.from_numpy(self._fft_bins().astype(np.int64)).to(samples.device)
        return freq[..., bins]

    def demodulate_subcarriers(self, samples) -> torch.Tensor:
        """(..., S·(cp+N)) -> (..., S, n_data) data points, equalised when
        the frame carries pilots."""
        occ = self.occupied_subcarriers(samples)
        pat = self.pilot_pattern
        if pat is None:
            return occ
        if self.num_training_symbols:
            data, _h, _cpe = ofdm_ops.equalize_packet(
                occ, pat, ofdm_ops.training_sequence(self.num_occupied),
                self.num_training_symbols, method=self.equalizer)
        else:
            data, _h, _cpe = ofdm_ops.equalize_frame(occ, pat, method=self.equalizer)
        return data

    def demodulate(self, samples) -> DemodResult:
        points = self.demodulate_subcarriers(samples)  # (S, n_sc)
        const = constellation_tensor(self.subcarrier_mod, points.device)
        values = nearest_points(points, const)
        bits = symbols_to_bits(values.reshape(*values.shape[:-2], -1), self.bits_per_subcarrier)
        err = points - const[values.long()]
        evm = torch.sqrt(torch.mean(err.real ** 2 + err.imag ** 2))
        return DemodResult(
            bits=pack_demod_bits(bits),
            symbols=values.reshape(-1),
            snr_estimate=float(-20.0 * torch.log10(torch.clamp_min(evm, 1e-12))),
            metadata={"evm_rms": float(evm)},
        )


@register_waveform("OFDM")
def _ofdm(sample_rate: float, device: torch.device) -> OFDM:
    # 64-point FFT, 48 data + 4 pilot subcarriers, CP 1/4, QPSK
    return OFDM(common=CommonParams(sample_rate=sample_rate), device=device)
