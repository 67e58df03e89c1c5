"""LoRa `Waveform` adapter.

Wraps the LoRa modem (`r4w_tpu_torch.waveforms.lora`) behind the generic
Waveform API. `demodulate` skips the preamble when the buffer holds one
followed by whole symbols, so modulate→demodulate round trips decode
cleanly, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, CommonParams, to_tensor
from r4w_tpu_torch.waveforms import lora
from r4w_tpu_torch.waveforms.base import (
    DemodResult,
    Waveform,
    WaveformInfo,
    coerce_data_bytes,
    register_waveform,
)


@dataclasses.dataclass(frozen=True)
class LoRaWaveform(Waveform):
    common: CommonParams = CommonParams()
    params: lora.LoRaParams = lora.LoRaParams()
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return self.params.samples_per_symbol

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="LoRa",
            full_name="Long Range Chirp Spread Spectrum",
            description="CSS modulation for long-range, low-power IoT links",
            complexity=4,
            bits_per_symbol=self.params.sf,
            characteristics=(
                "Chirp Spread Spectrum (CSS)",
                "FFT-based demodulation",
                "Configurable spreading factor (SF5-SF12)",
            ),
            history="Developed by Semtech; basis of LoRaWAN.",
            modern_usage="IoT sensors, smart cities, asset tracking",
        )

    def modulate(self, data) -> torch.Tensor:
        payload = torch.from_numpy(coerce_data_bytes(data))
        return lora.modulate(self.params, payload, device=self.device)

    def demodulate(self, samples) -> DemodResult:
        if not isinstance(samples, torch.Tensor):
            samples = to_tensor(samples, device=self.device)
        n_pre = self.params.n_preamble_samples()
        n_sym = self.params.samples_per_symbol
        # Skip the preamble if the buffer is long enough to contain one
        # whose remainder is whole symbols.
        if samples.shape[-1] > n_pre and (samples.shape[-1] - n_pre) % n_sym == 0:
            samples = samples[..., n_pre:]
        result = lora.demodulate(self.params, samples)
        return DemodResult(
            bits=result.payload,
            symbols=result.symbols,
            snr_estimate=float(torch.mean(result.snr_db)),
            metadata={
                "cfo": 0.0,
                "rssi": float(20.0 * torch.log10(torch.mean(result.magnitude))),
            },
        )


def _make(sample_rate: float, device: torch.device, sf: int) -> LoRaWaveform:
    return LoRaWaveform(
        common=CommonParams(sample_rate=sample_rate),
        params=lora.LoRaParams(sf=sf, bw_hz=125_000, cr=1),
        device=device,
    )


@register_waveform("LoRa", aliases=("CSS",))
def _lora(sample_rate: float, device: torch.device) -> LoRaWaveform:
    return _make(sample_rate, device, 7)


@register_waveform("LoRa-SF7", aliases=("LORASF7",))
def _lora_sf7(sample_rate: float, device: torch.device) -> LoRaWaveform:
    return _make(sample_rate, device, 7)


@register_waveform("LoRa-SF12", aliases=("LORASF12",))
def _lora_sf12(sample_rate: float, device: torch.device) -> LoRaWaveform:
    return _make(sample_rate, device, 12)
