"""GNSS waveforms behind the generic Waveform API.

PyTorch counterpart of ``r4w_tpu.waveforms.gnss_waveforms`` (re-designs of
waveform/gnss/mod.rs: gnss/gps_l1ca.rs, gnss/gps_l5.rs,
gnss/glonass_l1of.rs, gnss/galileo_e1.rs). Each data bit spans one code
period (BPSK data × spreading code; CBOC subcarrier for Galileo E1).
Demodulation is a batched prompt correlation per code period, an
elementwise product summed over the period (no matmul, so TF32 never
applies).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams, to_tensor)
from r4w_tpu_torch.gnss import boc, prn
from r4w_tpu_torch.waveforms.base import (
    DemodResult,
    Waveform,
    WaveformInfo,
    data_to_bits,
    register_waveform,
)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits

CHIP_RATE = 1_023_000.0
GLONASS_CHIP_RATE = 511_000.0
L5_CHIP_RATE = 10_230_000.0


@dataclasses.dataclass(frozen=True)
class GnssWaveform(Waveform):
    common: CommonParams = CommonParams(sample_rate=4_092_000.0)
    system: str = "gps_l1ca"
    prn: int = 1
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def _chip_rate(self) -> float:
        return {"gps_l1ca": CHIP_RATE, "galileo_e1": CHIP_RATE,
                "glonass_l1of": GLONASS_CHIP_RATE,
                "gps_l5": L5_CHIP_RATE}[self.system]

    @functools.cached_property
    def code(self) -> np.ndarray:
        if self.system == "gps_l1ca":
            return prn.gps_ca_code(self.prn).astype(np.float32)
        if self.system == "glonass_l1of":
            return prn.glonass_l1of_code().astype(np.float32)
        if self.system == "gps_l5":
            return prn.gps_l5_code(self.prn).astype(np.float32)
        if self.system == "galileo_e1":
            # E1B data channel chips with CBOC at 12 sub-chips
            chips = prn.galileo_e1_code(self.prn, "B")
            return boc.cboc_spread(chips, 12, pilot=False)
        raise ValueError(self.system)

    def _code_rate(self) -> float:
        """Rate of entries of `self.code` in Hz."""
        if self.system == "galileo_e1":
            return CHIP_RATE * 12
        return self._chip_rate()

    def samples_per_symbol(self) -> int:
        """Samples per code period (= per data bit here)."""
        period = len(self.code) / self._code_rate()
        return int(round(self.common.sample_rate * period))

    def info(self) -> WaveformInfo:
        names = {
            "gps_l1ca": ("GPS-L1CA", "GPS L1 C/A", "BPSK(1) Gold-code DSSS"),
            "gps_l5": ("GPS-L5", "GPS L5", "BPSK(10), 10230-chip codes"),
            "glonass_l1of": ("GLONASS-L1OF", "GLONASS L1OF",
                             "FDMA, 511-chip m-sequence"),
            "galileo_e1": ("Galileo-E1", "Galileo E1 OS",
                           "CBOC(6,1,1/11) on 4092-chip memory codes"),
        }
        n, f, d = names[self.system]
        return WaveformInfo(name=n, full_name=f, description=d, complexity=5,
                            bits_per_symbol=1)

    def _sampled_code(self, device: torch.device) -> torch.Tensor:
        n = self.samples_per_symbol()
        idx = (np.arange(n) * self._code_rate() / self.common.sample_rate
               ).astype(np.int64) % len(self.code)
        return torch.from_numpy(np.ascontiguousarray(self.code[idx], np.float32)).to(device)

    def modulate(self, data) -> torch.Tensor:
        bits = torch.from_numpy(data_to_bits(data)).to(self.device)
        symbols = (1.0 - 2.0 * bits).to(REAL_DTYPE)  # (B,)
        burst = symbols[:, None] * self._sampled_code(self.device)[None, :]
        return (self.common.amplitude * burst.reshape(-1)).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        if not isinstance(samples, torch.Tensor):
            samples = to_tensor(samples, device=self.device)
        samples = samples.to(IQ_DTYPE)
        n = self.samples_per_symbol()
        b = samples.shape[-1] // n
        if b == 0:
            empty = torch.zeros(0, dtype=SYMBOL_DTYPE, device=samples.device)
            return DemodResult(bits=empty, symbols=empty)
        code = self._sampled_code(samples.device)
        periods = samples[..., : b * n].reshape(*samples.shape[:-1], b, n)
        prompt = torch.sum(periods * code, dim=-1)
        bits = (prompt.real < 0).to(SYMBOL_DTYPE)
        p_pow = prompt.real ** 2 + prompt.imag ** 2
        total = torch.sum(torch.abs(periods) ** 2, dim=-1) * torch.sum(code ** 2)
        snr = 10.0 * torch.log10(torch.clamp(
            torch.mean(p_pow / torch.clamp(total - p_pow, min=1e-12)), min=1e-12))
        return DemodResult(
            bits=pack_demod_bits(bits),
            symbols=bits,
            snr_estimate=float(snr),
            metadata={"prn": float(self.prn),
                      "processing_gain_db": float(10 * np.log10(n))},
        )


def _make(system, sample_rate, device, prn_=1):
    return GnssWaveform(common=CommonParams(sample_rate=sample_rate), system=system, prn=prn_,
                        device=device)


@register_waveform("GPS-L1CA", aliases=("GPSL1", "GPSCA"))
def _gps_l1ca(sample_rate: float, device: torch.device) -> GnssWaveform:
    return _make("gps_l1ca", sample_rate, device)


@register_waveform("GPS-L5")
def _gps_l5(sample_rate: float, device: torch.device) -> GnssWaveform:
    return _make("gps_l5", sample_rate, device)


@register_waveform("GLONASS-L1OF", aliases=("GLONASS",))
def _glonass(sample_rate: float, device: torch.device) -> GnssWaveform:
    return _make("glonass_l1of", sample_rate, device)


@register_waveform("Galileo-E1", aliases=("GALILEO", "GAL"))
def _galileo_e1(sample_rate: float, device: torch.device) -> GnssWaveform:
    return _make("galileo_e1", sample_rate, device)


class GpsL1CaWaveform(GnssWaveform):
    """Dynamic GPS-L1CA-PRN<n> factory names (waveform/mod.rs:591-597)."""

    def __init__(self, sample_rate: float, prn: int, device=DEFAULT_DEVICE):
        super().__init__(common=CommonParams(sample_rate=sample_rate), system="gps_l1ca",
                         prn=prn, device=torch.device(device))
