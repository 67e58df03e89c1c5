"""Analog AM and FM waveforms.

PyTorch counterpart of ``r4w_tpu.waveforms.analog``. Audio in and out is
float32 in [-1, 1]; the byte API maps each byte to a signed 8-bit audio
sample. FM's phase integral is an inclusive float32 cumulative sum, and
its discriminator is angle(x[n]·conj(x[n-1])), wrapped to (-π, π].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams)
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          coerce_data_bytes, register_waveform)


def _bytes_to_audio(data, device) -> torch.Tensor:
    b = coerce_data_bytes(data).astype(np.int64)
    signed = np.where(b > 127, b - 256, b).astype(np.float32) / 128.0
    return torch.from_numpy(signed).to(device)


def _audio_to_bytes(audio: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(audio * 128.0, -128, 127).to(torch.int32)
    return torch.where(x < 0, x + 256, x)


def _audio(audio, device) -> torch.Tensor:
    if isinstance(audio, torch.Tensor):
        return audio.to(REAL_DTYPE)
    return torch.as_tensor(np.asarray(audio), dtype=REAL_DTYPE, device=device)


@dataclasses.dataclass(frozen=True)
class AM(Waveform):
    """AM: DSB-FC and DSB-SC."""

    common: CommonParams = CommonParams()
    carrier_freq: float = 1000.0
    modulation_index: float = 0.8
    variant: str = "dsb_fc"  # dsb_fc | dsb_sc
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return 1

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="AM-Broadcast", full_name="Amplitude Modulation",
            description="Analog audio on carrier amplitude",
            complexity=1, bits_per_symbol=8,
            characteristics=("Envelope detection", f"m={self.modulation_index}"),
        )

    def _carrier_phase(self, n: int, device) -> torch.Tensor:
        omega = 2.0 * np.pi * self.carrier_freq / self.common.sample_rate
        return omega * torch.arange(n, dtype=REAL_DTYPE, device=device)

    def modulate_audio(self, audio) -> torch.Tensor:
        audio = _audio(audio, self.device)
        phase = self._carrier_phase(audio.shape[-1], audio.device)
        if self.variant == "dsb_fc":
            env = self.common.amplitude * (1.0 + self.modulation_index * audio)
        else:  # dsb_sc
            env = self.common.amplitude * self.modulation_index * audio
        return (env * cis(phase)).to(IQ_DTYPE)

    def demodulate_audio(self, samples) -> torch.Tensor:
        samples = as_iq(samples, self.device)
        if self.variant == "dsb_fc":
            env = torch.abs(samples)
            return ((env / self.common.amplitude - 1.0) / self.modulation_index).to(REAL_DTYPE)
        ph = self._carrier_phase(samples.shape[-1], samples.device)
        return (samples.real * torch.cos(ph) + samples.imag * torch.sin(ph)).to(REAL_DTYPE)

    def modulate(self, data) -> torch.Tensor:
        return self.modulate_audio(_bytes_to_audio(data, self.device))

    def demodulate(self, samples) -> DemodResult:
        audio = self.demodulate_audio(samples)
        return DemodResult(bits=_audio_to_bytes(audio),
                           symbols=torch.zeros(0, dtype=SYMBOL_DTYPE, device=audio.device))


@dataclasses.dataclass(frozen=True)
class FM(Waveform):
    """FM: broadcast (75 kHz deviation) and narrowband (2.5 kHz)."""

    common: CommonParams = CommonParams()
    carrier_freq: float = 1000.0
    freq_deviation: float = 75_000.0
    audio_bandwidth: float = 15_000.0
    narrowband: bool = False
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return 1

    def info(self) -> WaveformInfo:
        name = "NBFM" if self.narrowband else "FM-Broadcast"
        return WaveformInfo(
            name=name, full_name="Frequency Modulation",
            description="Analog audio on carrier frequency",
            complexity=2, bits_per_symbol=8,
            characteristics=(f"deviation {self.freq_deviation/1e3:.1f} kHz",
                             "Constant envelope"),
        )

    def modulate_audio(self, audio) -> torch.Tensor:
        audio = _audio(audio, self.device)
        n = audio.shape[-1]
        omega_c = 2.0 * np.pi * self.carrier_freq / self.common.sample_rate
        k_f = 2.0 * np.pi * self.freq_deviation / self.common.sample_rate
        # inclusive cumulative sum: accumulate, then emit
        phase = (omega_c * torch.arange(n, dtype=REAL_DTYPE, device=audio.device)
                 + k_f * torch.cumsum(audio, dim=-1))
        return (self.common.amplitude * cis(phase)).to(IQ_DTYPE)

    def demodulate_audio(self, samples) -> torch.Tensor:
        samples = as_iq(samples, self.device)
        k_f = 2.0 * np.pi * self.freq_deviation / self.common.sample_rate
        omega_c = 2.0 * np.pi * self.carrier_freq / self.common.sample_rate
        d = samples[..., 1:] * torch.conj(samples[..., :-1])
        dphase = torch.angle(d)  # wrapped to (-π, π]
        return ((dphase - omega_c) / k_f).to(REAL_DTYPE)

    def modulate(self, data) -> torch.Tensor:
        return self.modulate_audio(_bytes_to_audio(data, self.device))

    def demodulate(self, samples) -> DemodResult:
        audio = self.demodulate_audio(samples)
        return DemodResult(bits=_audio_to_bytes(audio),
                           symbols=torch.zeros(0, dtype=SYMBOL_DTYPE, device=audio.device))


@register_waveform("AM-Broadcast", aliases=("AM",))
def _am(sample_rate: float, device: torch.device) -> AM:
    return AM(common=CommonParams(sample_rate=sample_rate), carrier_freq=1000.0,
              modulation_index=0.8, device=device)


@register_waveform("FM-Broadcast", aliases=("FM", "WBFM"))
def _fm(sample_rate: float, device: torch.device) -> FM:
    return FM(common=CommonParams(sample_rate=sample_rate), carrier_freq=1000.0,
              freq_deviation=75_000.0, audio_bandwidth=15_000.0, device=device)


@register_waveform("NBFM")
def _nbfm(sample_rate: float, device: torch.device) -> FM:
    return FM(common=CommonParams(sample_rate=sample_rate), carrier_freq=1000.0,
              freq_deviation=2500.0, audio_bandwidth=3000.0, narrowband=True, device=device)
