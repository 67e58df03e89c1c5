"""CW, OOK, ASK and FSK waveforms.

PyTorch counterpart of ``r4w_tpu.waveforms.simple_waveforms``: phase
accumulation is an exclusive float32 cumulative sum of per-sample
frequency increments, and demodulation reduces whole (S, sps) blocks at
once. `modulate` builds on the waveform's device; `demodulate` runs on
the device of a tensor input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core import fftops
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams)
from r4w_tpu_torch.ops.coding import bits_to_symbols, symbols_to_bits
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          data_to_bits, empty_result, host_table, register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits


def phase_accumulate(omega_per_sample: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum: phase[n] = sum of increments before n."""
    return torch.cumsum(omega_per_sample, dim=-1) - omega_per_sample


def symbol_blocks(samples: torch.Tensor, sps: int) -> torch.Tensor:
    """(..., N) -> (..., N // sps, sps), the tail dropped."""
    s = samples.shape[-1] // sps
    return samples[..., : s * sps].reshape(*samples.shape[:-1], s, sps)


def padded_bits(data, bits_per_symbol: int) -> np.ndarray:
    """`data_to_bits`, zero-padded to whole symbols."""
    bits = data_to_bits(data)
    rem = bits.size % bits_per_symbol
    if rem:
        bits = np.pad(bits, (0, bits_per_symbol - rem))
    return bits


def _sps(common: CommonParams, symbol_rate: float) -> int:
    if symbol_rate <= 0:
        return 1
    return max(int(common.sample_rate / symbol_rate), 1)


# --------------------------------------------------------------------------
# CW
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CW(Waveform):
    common: CommonParams = CommonParams()
    frequency: float = 1000.0
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return 1

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="CW", full_name="Continuous Wave", carries_data=False,
            bits_per_symbol=0, complexity=1,
            description="Pure sinusoidal tone at constant frequency",
        )

    def generate(self, duration_s: float) -> torch.Tensor:
        n = int(self.common.sample_rate * duration_s)
        t = (torch.arange(n, dtype=REAL_DTYPE, device=self.device)
             / torch.tensor(self.common.sample_rate, dtype=REAL_DTYPE, device=self.device))
        ph = 2.0 * np.pi * self.frequency * t
        return (self.common.amplitude * cis(ph)).to(IQ_DTYPE)

    def modulate(self, data=None) -> torch.Tensor:
        # CW carries no data: 1 ms of tone
        return self.generate(0.001)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        # interpolated FFT peak of the 8x zero-padded capture
        n = samples.shape[-1]
        nfft = 8 * n
        spec = fftops.power_spectrum(torch.nn.functional.pad(samples, (0, nfft - n)))
        idx, _ = fftops.find_peak_interpolated(spec)
        freq = torch.where(idx > nfft / 2, idx - nfft, idx) * (self.common.sample_rate / nfft)
        power = torch.mean(torch.abs(samples) ** 2, dim=-1)
        empty = torch.zeros(0, dtype=SYMBOL_DTYPE, device=samples.device)
        return DemodResult(bits=empty, symbols=empty,
                           metadata={"frequency": float(freq), "power": float(power)})


# --------------------------------------------------------------------------
# OOK
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OOK(Waveform):
    common: CommonParams = CommonParams()
    symbol_rate: float = 1000.0
    carrier_freq: float = 1000.0
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return _sps(self.common, self.symbol_rate)

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="OOK", full_name="On-Off Keying",
            description="Binary modulation by switching the carrier on/off",
            complexity=2, bits_per_symbol=1,
            characteristics=("Carrier ON = 1, OFF = 0", "Envelope detection"),
        )

    def modulate(self, data) -> torch.Tensor:
        bits = host_table(data_to_bits(data), self.device)
        omega = 2.0 * np.pi * self.carrier_freq / self.common.sample_rate
        on = bits.repeat_interleave(self.samples_per_symbol()).to(REAL_DTYPE)
        # the phase advances only while the carrier is on
        phase = phase_accumulate(on * omega)
        return (self.common.amplitude * on * cis(phase)).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        sps = self.samples_per_symbol()
        if samples.shape[-1] // sps == 0:  # shorter than one symbol
            return empty_result(samples.device)
        power = torch.mean(torch.abs(symbol_blocks(samples, sps)) ** 2, dim=-1)
        # adaptive threshold: midpoint of the min/max symbol power
        pmax = torch.amax(power, -1, keepdim=True)
        pmin = torch.amin(power, -1, keepdim=True)
        bits = (power > (pmax + pmin) / 2.0).to(SYMBOL_DTYPE)
        snr = 10.0 * torch.log10(pmax[..., 0] / torch.clamp_min(pmin[..., 0], 1e-10))
        return DemodResult(bits=pack_demod_bits(bits), symbols=bits, snr_estimate=float(snr))


# --------------------------------------------------------------------------
# ASK
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ASK(Waveform):
    common: CommonParams = CommonParams()
    symbol_rate: float = 1000.0
    carrier_freq: float = 1000.0
    num_levels: int = 2
    modulation_index: float = 1.0
    suppress_carrier: bool = False
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.num_levels))

    def samples_per_symbol(self) -> int:
        return _sps(self.common, self.symbol_rate)

    def info(self) -> WaveformInfo:
        name = "ASK" if self.num_levels == 2 else f"{self.num_levels}-ASK"
        return WaveformInfo(
            name=name, full_name="Amplitude Shift Keying",
            description="Data in discrete carrier amplitude levels",
            complexity=2, bits_per_symbol=self.bits_per_symbol,
        )

    def _levels(self) -> np.ndarray:
        """Per-symbol envelope."""
        m = self.num_levels
        sym = np.arange(m, dtype=np.float64)
        if self.suppress_carrier:
            norm = sym * 2.0 / (m - 1) - 1.0 if m > 2 else np.where(sym == 0, -1.0, 1.0)
            return (norm * self.modulation_index).astype(np.float32)
        if m == 2:
            return np.array([1.0 - self.modulation_index, 1.0 + self.modulation_index],
                            np.float32)
        norm = 2.0 * sym / (m - 1) - 1.0
        return (1.0 + self.modulation_index * norm).astype(np.float32)

    def modulate(self, data) -> torch.Tensor:
        bits = host_table(padded_bits(data, self.bits_per_symbol), self.device)
        symbols = bits_to_symbols(bits, self.bits_per_symbol)
        env = host_table(self._levels(), self.device)[symbols.long()]
        env_s = env.repeat_interleave(self.samples_per_symbol(), dim=-1)
        omega = 2.0 * np.pi * self.carrier_freq / self.common.sample_rate
        phase = omega * torch.arange(env_s.shape[-1], dtype=REAL_DTYPE, device=self.device)
        return (self.common.amplitude * env_s * cis(phase)).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        rms = torch.sqrt(torch.mean(
            torch.abs(symbol_blocks(samples, self.samples_per_symbol())) ** 2, dim=-1))
        expected = host_table(self._levels(), samples.device) * self.common.amplitude
        err = torch.abs(rms[..., None] - torch.abs(expected))
        symbols = torch.argmin(err, dim=-1).to(SYMBOL_DTYPE)
        bits = symbols_to_bits(symbols, self.bits_per_symbol)
        return DemodResult(bits=pack_demod_bits(bits), symbols=symbols)


# --------------------------------------------------------------------------
# FSK
# --------------------------------------------------------------------------


def mean_symbol_frequency(chunks: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """(..., S, sps) -> (..., S) mean instantaneous frequency in Hz: the
    angle of the summed lag-1 products."""
    d = chunks[..., 1:] * torch.conj(chunks[..., :-1])
    return torch.angle(torch.sum(d, dim=-1)) * sample_rate / (2.0 * np.pi)


@dataclasses.dataclass(frozen=True)
class FSK(Waveform):
    common: CommonParams = CommonParams()
    symbol_rate: float = 500.0
    deviation: float = 500.0
    num_levels: int = 2
    continuous_phase: bool = True
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.num_levels))

    def samples_per_symbol(self) -> int:
        return _sps(self.common, self.symbol_rate)

    def info(self) -> WaveformInfo:
        names = {2: ("BFSK", "Binary Frequency Shift Keying"),
                 4: ("4-FSK", "4-Level Frequency Shift Keying")}
        name, full = names.get(self.num_levels, ("M-FSK", "Multi-level FSK"))
        return WaveformInfo(
            name=name, full_name=full,
            description="Data in discrete carrier frequency shifts",
            complexity=2, bits_per_symbol=self.bits_per_symbol,
            characteristics=(f"h = {2*self.deviation/self.symbol_rate:.1f}",
                             "Constant envelope"),
        )

    def _freqs(self) -> np.ndarray:
        """Symbol frequencies in Hz."""
        m = self.num_levels
        sym = np.arange(m, dtype=np.float64)
        norm = np.where(sym == 0, -1.0, 1.0) if m == 2 else 2.0 * sym / (m - 1) - 1.0
        return (norm * self.deviation).astype(np.float32)

    def modulate(self, data) -> torch.Tensor:
        bits = host_table(padded_bits(data, self.bits_per_symbol), self.device)
        symbols = bits_to_symbols(bits, self.bits_per_symbol)
        freqs = host_table(self._freqs(), self.device)[symbols.long()]  # Hz per symbol
        sps = self.samples_per_symbol()
        omega = 2.0 * np.pi * freqs.repeat_interleave(sps, dim=-1) / self.common.sample_rate
        if self.continuous_phase:
            phase = phase_accumulate(omega)
        else:
            # the phase restarts each symbol
            k = torch.arange(omega.shape[-1], device=self.device) % sps
            phase = omega * k
        return (self.common.amplitude * cis(phase)).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        chunks = symbol_blocks(samples, self.samples_per_symbol())
        freq = mean_symbol_frequency(chunks, self.common.sample_rate)
        expected = host_table(self._freqs(), samples.device)
        symbols = torch.argmin(torch.abs(freq[..., None] - expected), dim=-1).to(SYMBOL_DTYPE)
        bits = symbols_to_bits(symbols, self.bits_per_symbol)
        return DemodResult(bits=pack_demod_bits(bits), symbols=symbols)


# --------------------------------------------------------------------------
# Factory registrations
# --------------------------------------------------------------------------


@register_waveform("CW")
def _cw(sample_rate: float, device: torch.device) -> CW:
    return CW(common=CommonParams(sample_rate=sample_rate), frequency=1000.0, device=device)


@register_waveform("OOK")
def _ook(sample_rate: float, device: torch.device) -> OOK:
    return OOK(common=CommonParams(sample_rate=sample_rate), symbol_rate=1000.0, device=device)


@register_waveform("ASK")
def _ask(sample_rate: float, device: torch.device) -> ASK:
    return ASK(common=CommonParams(sample_rate=sample_rate), symbol_rate=1000.0,
               carrier_freq=1000.0, num_levels=2, device=device)


@register_waveform("4-ASK", aliases=("4ASK", "PAM4"))
def _ask4(sample_rate: float, device: torch.device) -> ASK:
    return ASK(common=CommonParams(sample_rate=sample_rate), symbol_rate=1000.0,
               carrier_freq=1000.0, num_levels=4, device=device)


@register_waveform("BFSK", aliases=("FSK",))
def _bfsk(sample_rate: float, device: torch.device) -> FSK:
    return FSK(common=CommonParams(sample_rate=sample_rate), symbol_rate=500.0,
               deviation=500.0, num_levels=2, device=device)


@register_waveform("4-FSK", aliases=("4FSK",))
def _fsk4(sample_rate: float, device: torch.device) -> FSK:
    return FSK(common=CommonParams(sample_rate=sample_rate), symbol_rate=500.0,
               deviation=500.0, num_levels=4, device=device)
