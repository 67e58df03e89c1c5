"""Zigbee (802.15.4), UWB-IR (802.15.4a) and FMCW radar waveforms.

PyTorch counterpart of ``r4w_tpu.waveforms.iot_waveforms``: chip maps and
pulse templates are constant tables, symbols -> samples is a gather and a
reshape. Zigbee's chip correlator is an elementwise product summed over
the chips, then the first maximum; FMCW's range comes from `np.argmax`
of the beat power spectrum on the host, as the reference takes it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams)
from r4w_tpu_torch.ops.coding import bits_to_symbols, symbols_to_bits
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          data_to_bits, empty_result, register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits
from r4w_tpu_torch.waveforms.simple_waveforms import padded_bits, symbol_blocks

# ------------------------------------------------------------------ Zigbee

# IEEE 802.15.4 2.4 GHz O-QPSK: symbol 0's chip sequence; symbols 1-7 are
# cyclic left rotations by 4k chips; 8-15 invert the odd (Q) chips.
_ZB_SEQ0 = np.array(
    [1, 1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1,
     0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0], np.int8
)


@functools.lru_cache(maxsize=None)
def zigbee_chip_table() -> np.ndarray:
    """(16, 32) chip table."""
    table = np.zeros((16, 32), np.int8)
    for s in range(8):
        table[s] = np.roll(_ZB_SEQ0, -4 * s)
    conj = _ZB_SEQ0.copy()
    conj[1::2] ^= 1
    for s in range(8):
        table[8 + s] = np.roll(conj, -4 * s)
    return table


@dataclasses.dataclass(frozen=True)
class Zigbee(Waveform):
    """802.15.4 O-QPSK DSSS: 4-bit symbols -> 32 chips, half-sine shaping
    with Q offset by half a chip."""

    common: CommonParams = CommonParams(sample_rate=4_000_000.0)
    chip_rate: float = 2_000_000.0
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    @property
    def samples_per_chip(self) -> int:
        return max(int(self.common.sample_rate / self.chip_rate), 1)

    def samples_per_symbol(self) -> int:
        return 32 * self.samples_per_chip

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="Zigbee", full_name="IEEE 802.15.4 O-QPSK DSSS",
            description="2 Mchip/s O-QPSK with 32-chip PN spreading",
            complexity=4, bits_per_symbol=4,
            characteristics=("16-ary quasi-orthogonal chip map",
                             "Half-sine pulse shaping"),
        )

    def _chip_waveform(self, chips: torch.Tensor) -> torch.Tensor:
        """O-QPSK: even chips on I, odd chips on Q half a chip later, each a
        half-sine two chips long. Pulses of one rail do not overlap, so each
        rail is its pulse train placed at its offset."""
        spc = self.samples_per_chip
        c = 1.0 - 2.0 * chips.to(REAL_DTYPE)  # bit -> ±1
        half = torch.from_numpy(
            np.sin(np.pi * np.arange(2 * spc) / (2 * spc)).astype(np.float32)).to(c.device)
        n = c.shape[-1] * spc

        def lay(vals: torch.Tensor, offset: int) -> torch.Tensor:
            train = (vals[..., None] * half).reshape(*vals.shape[:-1], -1)
            out = torch.zeros(vals.shape[:-1] + (n + 2 * spc,), dtype=REAL_DTYPE,
                              device=vals.device)
            out[..., offset: offset + train.shape[-1]] = train
            return out[..., : n + spc]

        return torch.complex(lay(c[..., 0::2], 0), lay(c[..., 1::2], spc))

    def modulate(self, data) -> torch.Tensor:
        # 802.15.4 maps LSB-first nibbles; the reference keeps MSB-first groups
        bits = torch.from_numpy(padded_bits(data, 4)).to(self.device)
        symbols = bits_to_symbols(bits, 4)
        table = torch.from_numpy(zigbee_chip_table()).to(self.device)
        chips = table[symbols.long()]  # (S, 32)
        return self.common.amplitude * self._chip_waveform(chips.reshape(-1))

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        dev = samples.device
        spc = self.samples_per_chip
        n_sym = samples.shape[-1] // self.samples_per_symbol()
        if n_sym == 0:
            return empty_result(dev)
        # chip-rate samples at the half-sine peaks, mid-chip
        idx = torch.arange(n_sym * 16, device=dev)
        i_samp = samples.real[..., idx * 2 * spc + spc]
        q_samp = samples.imag[..., torch.clamp_max(idx * 2 * spc + 2 * spc,
                                                   samples.shape[-1] - 1)]
        rx = torch.stack([i_samp, q_samp], dim=-1).reshape(*samples.shape[:-1], n_sym, 32)
        table = 1.0 - 2.0 * torch.from_numpy(zigbee_chip_table().astype(np.float32)).to(dev)
        corr = torch.sum(rx[..., None, :] * table, dim=-1)  # (..., S, 16)
        symbols = torch.argmax(corr, dim=-1).to(SYMBOL_DTYPE)
        bits = symbols_to_bits(symbols, 4)
        return DemodResult(bits=pack_demod_bits(bits), symbols=symbols)


# ------------------------------------------------------------------ UWB-IR


@dataclasses.dataclass(frozen=True)
class UwbIr(Waveform):
    """802.15.4a impulse radio, burst-position modulated: bit 0 puts the
    burst of Gaussian monocycles in the first half of the symbol, bit 1 in
    the second."""

    common: CommonParams = CommonParams(sample_rate=499_200_000.0)
    symbol_rate: float = 976_562.5  # ~0.9766 Msym/s
    pulses_per_burst: int = 16
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return max(int(self.common.sample_rate / self.symbol_rate), 4)

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="UWB", full_name="IEEE 802.15.4a UWB Impulse Radio",
            description="Burst-position modulated sub-ns pulses",
            complexity=4, bits_per_symbol=1,
            characteristics=("Gaussian monocycles",
                             "Non-coherent energy detection"),
        )

    @functools.cached_property
    def _pulse(self) -> np.ndarray:
        """Gaussian monocycle, ~4 samples wide."""
        n = 8
        t = (np.arange(n) - n / 2) / (n / 5)
        p = -t * np.exp(-t * t / 2)
        return (p / np.max(np.abs(p))).astype(np.float32)

    def modulate(self, data) -> torch.Tensor:
        # the burst layout is built on the host, as the reference builds it
        bits = data_to_bits(data)
        sps = self.samples_per_symbol()
        burst_len = self.pulses_per_burst * len(self._pulse)
        burst = np.tile(self._pulse, self.pulses_per_burst)
        out = np.zeros(len(bits) * sps, np.float32)
        starts = np.arange(len(bits)) * sps + np.where(bits, sps // 2, 0)
        for s in starts:
            seg = out[s: s + burst_len]
            seg += burst[: len(seg)]
        return (self.common.amplitude * torch.from_numpy(out).to(self.device)).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        sps = self.samples_per_symbol()
        if samples.shape[-1] // sps == 0:
            return empty_result(samples.device)
        chunks = symbol_blocks(samples, sps)
        power = chunks.real ** 2 + chunks.imag ** 2
        half = sps // 2
        e0 = torch.sum(power[..., :half], dim=-1)
        e1 = torch.sum(power[..., half:], dim=-1)
        bits = (e1 > e0).to(SYMBOL_DTYPE)
        return DemodResult(bits=pack_demod_bits(bits), symbols=bits)


# ------------------------------------------------------------------- FMCW

SPEED_OF_LIGHT = 299_792_458.0


@dataclasses.dataclass(frozen=True)
class Fmcw(Waveform):
    """FMCW radar: sawtooth LFM sweeps; 'demodulation' estimates the beat
    frequency, hence the range, of a delayed echo."""

    common: CommonParams = CommonParams(sample_rate=1_000_000.0)
    sweep_bandwidth: float = 500_000.0
    sweep_time: float = 0.001
    num_sweeps: int = 4
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return int(self.common.sample_rate * self.sweep_time)

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="FMCW", full_name="Frequency-Modulated Continuous Wave",
            description="Linear chirp sweeps; beat frequency ∝ range",
            complexity=3, bits_per_symbol=0, carries_data=False,
            characteristics=(
                f"range resolution {2.998e8/(2*self.sweep_bandwidth):.0f} m",
            ),
        )

    def sweep(self, device=None) -> torch.Tensor:
        device = self.device if device is None else device
        n = self.samples_per_symbol()
        t = (torch.arange(n, dtype=REAL_DTYPE, device=device)
             / torch.tensor(self.common.sample_rate, dtype=REAL_DTYPE, device=device))
        k = self.sweep_bandwidth / self.sweep_time
        phase = 2.0 * np.pi * (-self.sweep_bandwidth / 2.0 * t + 0.5 * k * t * t)
        return cis(phase).to(IQ_DTYPE)

    def modulate(self, data=None) -> torch.Tensor:
        return (self.common.amplitude * self.sweep().repeat(self.num_sweeps)).to(IQ_DTYPE)

    def beat_spectrum(self, echo) -> torch.Tensor:
        """Mix the echo against the reference sweep and average the power
        spectra of the sweeps."""
        echo = as_iq(echo, self.device)
        n = self.samples_per_symbol()
        k = echo.shape[-1] // n
        mixed = (echo[..., : k * n].reshape(*echo.shape[:-1], k, n)
                 * torch.conj(self.sweep(echo.device)))
        spec = torch.fft.fft(mixed, dim=-1)
        return torch.mean(spec.real ** 2 + spec.imag ** 2, dim=-2)

    def estimate_range(self, echo) -> float:
        """Beat frequency -> range of a two-way echo."""
        power = self.beat_spectrum(echo).cpu().numpy()
        n = self.samples_per_symbol()
        bin_ = int(np.argmax(power))
        if bin_ > n // 2:
            bin_ -= n
        beat_hz = bin_ * self.common.sample_rate / n
        slope = self.sweep_bandwidth / self.sweep_time
        return abs(beat_hz) * SPEED_OF_LIGHT / (2.0 * slope)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        empty = torch.zeros(0, dtype=SYMBOL_DTYPE, device=samples.device)
        return DemodResult(bits=empty, symbols=empty,
                           metadata={"range_m": float(self.estimate_range(samples))})


@register_waveform("Zigbee", aliases=("802154",))
def _zigbee(sample_rate: float, device: torch.device) -> Zigbee:
    return Zigbee(common=CommonParams(sample_rate=max(sample_rate, 4e6)), device=device)


@register_waveform("UWB", aliases=("UWBIR",))
def _uwb(sample_rate: float, device: torch.device) -> UwbIr:
    return UwbIr(common=CommonParams(sample_rate=max(sample_rate, 8e6)),
                 symbol_rate=max(sample_rate, 8e6) / 512.0, device=device)


@register_waveform("FMCW")
def _fmcw(sample_rate: float, device: torch.device) -> Fmcw:
    return Fmcw(common=CommonParams(sample_rate=sample_rate),
                sweep_bandwidth=sample_rate * 0.4, device=device)
