"""DSSS waveform.

PyTorch counterpart of ``r4w_tpu.waveforms.dsss``. Spreading is an outer
product, symbols (S,) × chips (C,) -> (S, C), then a repeat per chip;
despreading is the matched product with the chips summed over the chip
and oversample axes (an elementwise product and a sum, where the
reference writes an einsum).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, CommonParams
from r4w_tpu_torch.ops import spreading
from r4w_tpu_torch.ops.coding import bits_to_symbols, symbols_to_bits
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits
from r4w_tpu_torch.waveforms.ofdm import constellation_tensor, nearest_points
from r4w_tpu_torch.waveforms.simple_waveforms import padded_bits


@dataclasses.dataclass(frozen=True)
class DSSS(Waveform):
    common: CommonParams = CommonParams()
    pn_type: str = "gold"  # gold | msequence | barker
    pn_degree: int = 7
    code_index: int = 2
    modulation: str = "bpsk"  # bpsk | qpsk
    samples_per_chip: int = 4
    barker_length: int = 13
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    @property
    def bits_per_symbol(self) -> int:
        return {"bpsk": 1, "qpsk": 2}[self.modulation]

    def pn_sequence(self) -> np.ndarray:
        if self.pn_type == "gold":
            return spreading.gold_code(self.pn_degree, self.code_index)
        if self.pn_type == "msequence":
            return spreading.m_sequence(self.pn_degree)
        if self.pn_type == "barker":
            return spreading.barker_code(self.barker_length)
        raise ValueError(f"unknown pn_type {self.pn_type}")

    @property
    def chips_per_symbol(self) -> int:
        return len(self.pn_sequence())

    def samples_per_symbol(self) -> int:
        return self.chips_per_symbol * self.samples_per_chip

    def processing_gain_db(self) -> float:
        return 10.0 * np.log10(self.chips_per_symbol)

    def chip_rate(self) -> float:
        return self.common.sample_rate / self.samples_per_chip

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="DSSS" if self.modulation == "bpsk" else "DSSS-QPSK",
            full_name="Direct Sequence Spread Spectrum",
            description="Symbols spread by a PN chip sequence (LPD/LPI)",
            complexity=4, bits_per_symbol=self.bits_per_symbol,
            characteristics=(
                f"{self.chips_per_symbol} chips/symbol "
                f"({self.processing_gain_db():.0f} dB processing gain)",
            ),
        )

    def _chips(self, device) -> torch.Tensor:
        return torch.from_numpy(self.pn_sequence().astype(np.float32)).to(device)

    def modulate(self, data) -> torch.Tensor:
        bits = torch.from_numpy(padded_bits(data, self.bits_per_symbol)).to(self.device)
        values = bits_to_symbols(bits, self.bits_per_symbol)
        symbols = constellation_tensor(self.modulation, self.device)[values.long()]  # (S,)
        spread = symbols[..., None] * self._chips(self.device)  # (S, C)
        spread = spread.repeat_interleave(self.samples_per_chip, dim=-1)
        return (self.common.amplitude * spread.reshape(-1)).to(IQ_DTYPE)

    def despread(self, samples) -> torch.Tensor:
        """(..., S·C·osc) -> (..., S) despread symbol estimates."""
        samples = as_iq(samples, self.device)
        n = self.samples_per_symbol()
        s = samples.shape[-1] // n
        blocks = samples[..., : s * n].reshape(*samples.shape[:-1], s, self.chips_per_symbol,
                                                self.samples_per_chip)
        chips = self._chips(samples.device)[:, None].to(REAL_DTYPE)
        # matched filter: sum over chips × oversample, normalised
        acc = torch.sum(blocks * chips, dim=(-2, -1))
        return acc / (self.chips_per_symbol * self.samples_per_chip)

    def demodulate(self, samples) -> DemodResult:
        est = self.despread(samples) / self.common.amplitude
        const = constellation_tensor(self.modulation, est.device)
        values = nearest_points(est, const)
        bits = symbols_to_bits(values, self.bits_per_symbol)
        err = est - const[values.long()]
        evm = torch.sqrt(torch.mean(err.real ** 2 + err.imag ** 2, dim=-1))
        return DemodResult(
            bits=pack_demod_bits(bits),
            symbols=values,
            snr_estimate=float(-20.0 * torch.log10(torch.clamp_min(torch.mean(evm), 1e-12))),
            metadata={"chip_rate": self.chip_rate(),
                      "processing_gain_db": self.processing_gain_db()},
        )


@register_waveform("DSSS")
def _dsss(sample_rate: float, device: torch.device) -> DSSS:
    return DSSS(common=CommonParams(sample_rate=sample_rate), device=device)


@register_waveform("DSSS-QPSK", aliases=("DSSSQPSK",))
def _dsss_qpsk(sample_rate: float, device: torch.device) -> DSSS:
    return DSSS(common=CommonParams(sample_rate=sample_rate), modulation="qpsk", device=device)
