"""PPM and the ADS-B pulse waveform.

PyTorch counterpart of ``r4w_tpu.waveforms.ppm``. Standard PPM places a
quarter-symbol pulse early (bit 1) or late (bit 0); ADS-B uses 1 µs
Manchester-style pulses behind the 8 µs Mode-S preamble. Pulse placement
is one mask over (S, sps); demodulation compares the energy of each
symbol's two halves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams)
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          data_to_bits, register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits
from r4w_tpu_torch.waveforms.simple_waveforms import symbol_blocks


@dataclasses.dataclass(frozen=True)
class PPM(Waveform):
    common: CommonParams = CommonParams()
    symbol_rate: float = 1000.0
    variant: str = "standard"  # standard | adsb
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        if self.symbol_rate <= 0:
            return 1
        return max(int(self.common.sample_rate / self.symbol_rate), 1)

    def info(self) -> WaveformInfo:
        name = "ADS-B" if self.variant == "adsb" else "PPM"
        return WaveformInfo(
            name=name, full_name="Pulse Position Modulation",
            description="Data in the temporal position of pulses",
            complexity=2, bits_per_symbol=1,
            characteristics=("Non-coherent energy detection",),
        )

    def _masks(self) -> tuple[np.ndarray, np.ndarray]:
        """(bit-1 pulse, bit-0 pulse) over one symbol."""
        sps = self.samples_per_symbol()
        idx = np.arange(sps)
        if self.variant == "adsb":
            half = sps // 2
            return (idx < half).astype(np.float32), (idx >= half).astype(np.float32)
        w = sps // 4
        one = ((idx >= sps // 4) & (idx < sps // 4 + w)).astype(np.float32)
        zero_pos = sps * 3 // 4 - w
        zero = ((idx >= zero_pos) & (idx < zero_pos + w)).astype(np.float32)
        return one, zero

    def adsb_preamble(self) -> torch.Tensor:
        """8 µs Mode-S preamble: 0.5 µs pulses at 0, 1, 3.5, 4.5 µs."""
        sps = self.samples_per_symbol()
        half = sps // 2
        mask = np.zeros(sps * 8, np.float32)
        for start_us in (0.0, 1.0, 3.5, 4.5):
            s = int(start_us * sps)
            mask[s: s + half] = 1.0
        return (self.common.amplitude * torch.from_numpy(mask).to(self.device)).to(IQ_DTYPE)

    def modulate(self, data) -> torch.Tensor:
        bits = torch.from_numpy(data_to_bits(data)).to(self.device)
        one, zero = (torch.from_numpy(m).to(self.device) for m in self._masks())
        b = bits[..., None].to(REAL_DTYPE)  # (S, 1)
        pulses = b * one + (1.0 - b) * zero  # (S, sps)
        body = (self.common.amplitude * pulses.reshape(*bits.shape[:-1], -1)).to(IQ_DTYPE)
        if self.variant == "adsb":
            return torch.cat([self.adsb_preamble(), body])
        return body

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        sps = self.samples_per_symbol()
        if self.variant == "adsb":
            n_pre = sps * 8
            if samples.shape[-1] > n_pre and (samples.shape[-1] - n_pre) % sps == 0:
                samples = samples[..., n_pre:]
        chunks = symbol_blocks(samples, sps)
        power = chunks.real ** 2 + chunks.imag ** 2
        first = torch.sum(power[..., : sps // 2], dim=-1)
        second = torch.sum(power[..., sps // 2:], dim=-1)
        bits = (first > second).to(SYMBOL_DTYPE)
        return DemodResult(bits=pack_demod_bits(bits), symbols=bits)


@register_waveform("PPM")
def _ppm(sample_rate: float, device: torch.device) -> PPM:
    return PPM(common=CommonParams(sample_rate=sample_rate), symbol_rate=1000.0,
               variant="standard", device=device)


@register_waveform("ADS-B", aliases=("ADSB",))
def _adsb(sample_rate: float, device: torch.device) -> PPM:
    # 1 Mbit/s: one bit per microsecond
    return PPM(common=CommonParams(sample_rate=sample_rate), symbol_rate=1_000_000.0,
               variant="adsb", device=device)
