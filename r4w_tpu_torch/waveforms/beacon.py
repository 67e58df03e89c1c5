"""Emergency distress beacons: ELT/EPIRB/PLB on 121.5 MHz and the military
243 MHz beacon.

PyTorch counterpart of ``r4w_tpu.waveforms.beacon``: a swept audio tone
(e.g. 1600 -> 300 Hz, several sweeps a second), AM-modulated at high
depth. The receiver counts the envelope's zero crossings in 50 ms
windows, and reports the range of the audio frequency they imply and
whether it swept (`sweep_detected`, `audio_freq_min`, `audio_freq_max`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams)
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          register_waveform)


@dataclasses.dataclass(frozen=True)
class Beacon(Waveform):
    common: CommonParams = CommonParams(sample_rate=48_000.0)
    variant: str = "ELT"  # ELT | EPIRB | PLB | MIL243
    sweep_high_hz: float = 1600.0
    sweep_low_hz: float = 300.0
    sweep_rate_hz: float = 3.0  # sweeps per second (2-4 typical)
    modulation_depth: float = 0.9
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return 1

    def info(self) -> WaveformInfo:
        freq = "243 MHz" if self.variant == "MIL243" else "121.5 MHz"
        return WaveformInfo(
            name={"ELT": "ELT-121.5", "EPIRB": "EPIRB-121.5",
                  "PLB": "PLB-121.5", "MIL243": "Beacon-243"}[self.variant],
            full_name=f"{self.variant} emergency distress beacon ({freq})",
            description="Downward swept-tone AM distress signal",
            complexity=1, bits_per_symbol=0, carries_data=False,
            characteristics=(
                f"sweep {self.sweep_high_hz:.0f}→{self.sweep_low_hz:.0f} Hz",
                f"{self.sweep_rate_hz:.0f} sweeps/s, "
                f"{self.modulation_depth*100:.0f}% AM",
            ),
        )

    def generate(self, duration_s: float) -> torch.Tensor:
        fs = self.common.sample_rate
        fs_t = torch.tensor(fs, dtype=REAL_DTYPE, device=self.device)
        t = torch.arange(int(fs * duration_s), dtype=REAL_DTYPE, device=self.device) / fs_t
        # sawtooth sweep position in [0, 1): high -> low
        pos = torch.remainder(t * self.sweep_rate_hz, 1.0)
        f_audio = self.sweep_high_hz + (self.sweep_low_hz - self.sweep_high_hz) * pos
        audio = torch.cos(2.0 * np.pi * torch.cumsum(f_audio, dim=-1) / fs_t)
        env = (self.common.amplitude * (1.0 + self.modulation_depth * audio)
               / (1.0 + self.modulation_depth))
        return env.to(REAL_DTYPE).to(IQ_DTYPE)

    def modulate(self, data=None) -> torch.Tensor:
        # beacons carry no data: 1 s of signal
        return self.generate(1.0)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        env = torch.abs(samples)
        env = env - torch.mean(env)
        # the envelope's audio frequency from its zero crossings per window
        fs = self.common.sample_rate
        crossings = torch.abs(torch.diff(torch.sign(env))) > 0
        win = max(int(fs / 20), 1)  # 50 ms windows
        n = crossings.shape[-1] // win
        counts = torch.sum(crossings[: n * win].reshape(n, win), dim=-1)
        # a tone at f makes 2f zero crossings a second
        f_est = (counts / (2.0 * (win / fs))).cpu().numpy()
        hi = float(np.max(f_est)) if n else 0.0
        lo = float(np.min(f_est)) if n else 0.0
        empty = torch.zeros(0, dtype=SYMBOL_DTYPE, device=samples.device)
        return DemodResult(
            bits=empty, symbols=empty,
            metadata={"audio_freq_max": hi, "audio_freq_min": lo,
                      "sweep_detected": float((hi - lo) > 200.0)},
        )


def _mk(variant, sample_rate, device, **kw):
    return Beacon(common=CommonParams(sample_rate=max(sample_rate, 48_000.0)),
                  variant=variant, device=device, **kw)


@register_waveform("ELT-121.5", aliases=("ELT", "ELT1215"))
def _elt(sample_rate: float, device: torch.device) -> Beacon:
    return _mk("ELT", sample_rate, device)


@register_waveform("EPIRB-121.5", aliases=("EPIRB", "EPIRB1215"))
def _epirb(sample_rate: float, device: torch.device) -> Beacon:
    return _mk("EPIRB", sample_rate, device, sweep_rate_hz=2.5)


@register_waveform("PLB-121.5", aliases=("PLB", "PLB1215"))
def _plb(sample_rate: float, device: torch.device) -> Beacon:
    return _mk("PLB", sample_rate, device, sweep_rate_hz=4.0)


@register_waveform("Beacon-243", aliases=("MILITARY243", "MIL243"))
def _mil243(sample_rate: float, device: torch.device) -> Beacon:
    return _mk("MIL243", sample_rate, device, sweep_rate_hz=3.0)
