"""QAM waveforms: 16-, 64- and 256-QAM.

PyTorch counterpart of ``r4w_tpu.waveforms.qam``: square grids of unit
average power with 2-D Gray coding, on the shared linear modulation core.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, CommonParams
from r4w_tpu_torch.waveforms import linear_mod as lm
from r4w_tpu_torch.waveforms.base import DemodResult, Waveform, WaveformInfo, register_waveform


@dataclasses.dataclass(frozen=True)
class QAM(Waveform):
    common: CommonParams = CommonParams()
    symbol_rate: float = 1000.0
    order: int = 16
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.order))

    def samples_per_symbol(self) -> int:
        if self.symbol_rate <= 0:
            return 1
        return max(int(self.common.sample_rate / self.symbol_rate), 1)

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name=f"{self.order}-QAM",
            full_name=f"{self.order}-point Quadrature Amplitude Modulation",
            description="Joint amplitude+phase modulation on a square grid",
            complexity=3, bits_per_symbol=self.bits_per_symbol,
            characteristics=("Square constellation, unit average power",
                             "2-D Gray coding"),
        )

    def _tables(self):
        return (lm.qam_constellation(self.order, self.common.amplitude),
                lm.qam_value_to_index(self.order))

    def constellation_points(self) -> torch.Tensor:
        return torch.from_numpy(self._tables()[0]).to(self.device)

    def modulate(self, data) -> torch.Tensor:
        return lm.modulate_data(data, *self._tables(), self.bits_per_symbol,
                                self.samples_per_symbol(), self.device)

    def demodulate(self, samples) -> DemodResult:
        return lm.demodulate_samples(samples, *self._tables(), self.bits_per_symbol,
                                     self.samples_per_symbol(), self.device)


def _make(sample_rate: float, device: torch.device, order: int) -> QAM:
    return QAM(common=CommonParams(sample_rate=sample_rate), order=order, device=device)


@register_waveform("16-QAM", aliases=("16QAM", "QAM16"))
def _qam16(sample_rate: float, device: torch.device) -> QAM:
    return _make(sample_rate, device, 16)


@register_waveform("64-QAM", aliases=("64QAM", "QAM64"))
def _qam64(sample_rate: float, device: torch.device) -> QAM:
    return _make(sample_rate, device, 64)


@register_waveform("256-QAM", aliases=("256QAM", "QAM256"))
def _qam256(sample_rate: float, device: torch.device) -> QAM:
    return _make(sample_rate, device, 256)
