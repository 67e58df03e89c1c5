"""PSK waveforms: BPSK, QPSK and 8-PSK.

PyTorch counterpart of ``r4w_tpu.waveforms.psk``: the shared linear
modulation core (one gather for TX, one distance and argmin for RX).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, CommonParams
from r4w_tpu_torch.waveforms import linear_mod as lm
from r4w_tpu_torch.waveforms.base import DemodResult, Waveform, WaveformInfo, register_waveform

_NAMES = {2: ("BPSK", "Binary Phase Shift Keying"),
          4: ("QPSK", "Quadrature Phase Shift Keying"),
          8: ("8-PSK", "8-Phase Shift Keying")}


@dataclasses.dataclass(frozen=True)
class PSK(Waveform):
    common: CommonParams = CommonParams()
    symbol_rate: float = 1000.0
    num_phases: int = 2
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.num_phases))

    def samples_per_symbol(self) -> int:
        if self.symbol_rate <= 0:
            return 1
        return max(int(self.common.sample_rate / self.symbol_rate), 1)

    def info(self) -> WaveformInfo:
        name, full = _NAMES.get(self.num_phases, ("M-PSK", "Multi-PSK"))
        return WaveformInfo(
            name=name, full_name=full,
            description="Encodes data in the phase of the carrier",
            complexity=2, bits_per_symbol=self.bits_per_symbol,
            characteristics=("Constant envelope", "Gray-coded constellation"),
        )

    def _tables(self):
        return (lm.psk_constellation(self.num_phases, self.common.amplitude),
                lm.psk_value_to_index(self.num_phases))

    def constellation_points(self) -> torch.Tensor:
        return torch.from_numpy(self._tables()[0]).to(self.device)

    def modulate(self, data) -> torch.Tensor:
        return lm.modulate_data(data, *self._tables(), self.bits_per_symbol,
                                self.samples_per_symbol(), self.device)

    def demodulate(self, samples) -> DemodResult:
        return lm.demodulate_samples(samples, *self._tables(), self.bits_per_symbol,
                                     self.samples_per_symbol(), self.device)


def _make(sample_rate: float, device: torch.device, m: int) -> PSK:
    return PSK(common=CommonParams(sample_rate=sample_rate), num_phases=m, device=device)


@register_waveform("BPSK")
def _bpsk(sample_rate: float, device: torch.device) -> PSK:
    return _make(sample_rate, device, 2)


@register_waveform("QPSK")
def _qpsk(sample_rate: float, device: torch.device) -> PSK:
    return _make(sample_rate, device, 4)


@register_waveform("8-PSK", aliases=("8PSK", "PSK8"))
def _8psk(sample_rate: float, device: torch.device) -> PSK:
    return _make(sample_rate, device, 8)
