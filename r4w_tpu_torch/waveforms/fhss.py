"""FHSS waveform and its anti-jam variant (jammed-channel avoidance).

PyTorch counterpart of ``r4w_tpu.waveforms.fhss``. The hop schedule is a
precomputed LFSR-driven channel sequence (`ops.spreading.lfsr_bits` with
`MSEQ_POLY`, built on the host); the whole burst is one (n_hops,
samples_per_hop) grid whose per-sample frequency is the hop's channel
offset plus the symbol's BFSK deviation.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams)
from r4w_tpu_torch.ops import spreading
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          data_to_bits, register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits
from r4w_tpu_torch.waveforms.simple_waveforms import mean_symbol_frequency


@functools.lru_cache(maxsize=None)
def hop_sequence(num_channels: int, seed: int) -> tuple[int, ...]:
    """Pseudo-random hop channel sequence: a degree-n LFSR, n bits per
    hop, modulo num_channels."""
    degree = max(5, min(10, int(np.ceil(np.log2(num_channels)))))
    poly = spreading.MSEQ_POLY[degree]
    period = (1 << degree) - 1
    bits = spreading.lfsr_bits(degree, poly, seed % (1 << degree) or 1, length=period * degree)
    seq = []
    for i in range(period):
        val = 0
        for b in bits[i * degree: (i + 1) * degree]:
            val = (val << 1) | int(b)
        seq.append(val % num_channels)
    return tuple(seq)


@dataclasses.dataclass(frozen=True)
class FHSS(Waveform):
    common: CommonParams = CommonParams()
    num_channels: int = 50
    channel_spacing: float = 25_000.0
    hop_rate: float = 100.0
    symbols_per_hop: int = 10
    symbol_rate: float = 1000.0
    hop_pattern: str = "pseudorandom"  # pseudorandom | sequential
    modulation: str = "bfsk"  # bfsk only
    deviation: float = 5000.0
    seed: int = 0x12345
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return max(int(self.common.sample_rate / self.symbol_rate), 1)

    def samples_per_hop(self) -> int:
        return int(self.common.sample_rate / self.hop_rate)

    @property
    def bits_per_hop(self) -> int:
        return self.symbols_per_hop  # BFSK: 1 bit a symbol

    def processing_gain_db(self) -> float:
        return 10.0 * np.log10(self.num_channels)

    def total_bandwidth(self) -> float:
        return self.num_channels * self.channel_spacing

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="FHSS", full_name="Frequency Hopping Spread Spectrum",
            description="Carrier hops across channels per a PN schedule",
            complexity=4, bits_per_symbol=1,
            characteristics=(
                f"{self.num_channels} channels × {self.channel_spacing/1e3:.0f} kHz",
                f"{self.hop_rate:.0f} hops/s",
            ),
        )

    def _channels_for(self, n_hops: int) -> np.ndarray:
        if self.hop_pattern == "sequential":
            return np.arange(n_hops) % self.num_channels
        seq = np.asarray(hop_sequence(self.num_channels, self.seed))
        return seq[np.arange(n_hops) % len(seq)]

    def _channel_freq(self, channel: np.ndarray) -> np.ndarray:
        # centred about 0
        return (channel - self.num_channels / 2.0) * self.channel_spacing

    def _hop_offsets(self, n_hops: int, device) -> torch.Tensor:
        """(H,) float32 channel offsets in Hz, cast on the host as the
        reference casts them."""
        freqs = self._channel_freq(self._channels_for(n_hops)).astype(np.float32)
        return torch.from_numpy(freqs).to(device)

    def _hop_time(self, used: int, device) -> torch.Tensor:
        return (torch.arange(used, dtype=REAL_DTYPE, device=device)
                / torch.tensor(self.common.sample_rate, dtype=REAL_DTYPE, device=device))

    def modulate(self, data) -> torch.Tensor:
        bits = data_to_bits(data)
        bph = self.bits_per_hop
        n_hops = max(1, -(-bits.size // bph))
        n_data = bits.size
        bits = np.pad(bits, (0, n_hops * bph - n_data))
        bits_h = torch.from_numpy(bits.reshape(n_hops, bph)).to(self.device)

        sps = self.samples_per_symbol()
        hop_len = self.samples_per_hop()
        freqs = self._hop_offsets(n_hops, self.device)  # (H,)
        # per-symbol frequency: bit 0 -> +dev, bit 1 -> -dev
        f_sym = freqs[:, None] + self.deviation * (1.0 - 2.0 * bits_h)  # (H, B)
        f_sample = f_sym.repeat_interleave(sps, dim=-1)  # (H, B·sps)
        used = f_sample.shape[-1]
        phase = 2.0 * np.pi * f_sample * self._hop_time(used, self.device)[None, :]
        burst = self.common.amplitude * cis(phase)
        # silence the symbols past the data and pad the dwell to samples_per_hop
        sym_idx = (torch.arange(bph * sps, device=self.device) // sps
                   + torch.arange(n_hops, device=self.device)[:, None] * bph)
        burst = burst * (sym_idx < n_data).to(REAL_DTYPE)
        if used < hop_len:
            burst = torch.nn.functional.pad(burst, (0, hop_len - used))
        return burst.reshape(-1).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        dev = samples.device
        hop_len = self.samples_per_hop()
        sps = self.samples_per_symbol()
        n_hops = samples.shape[-1] // hop_len
        hops = samples[..., : n_hops * hop_len].reshape(*samples.shape[:-1], n_hops, hop_len)
        used = self.bits_per_hop * sps
        # mix down by the synchronised hop carrier on the transmitter's time
        # grid (t from the hop's start)
        offsets = self._hop_offsets(n_hops, dev)
        carrier = cis(-2.0 * np.pi * offsets[:, None] * self._hop_time(used, dev)[None, :])
        base = hops[..., :used] * carrier.to(IQ_DTYPE)
        chunks = base.reshape(*hops.shape[:-1], self.bits_per_hop, sps)
        # residual per-symbol frequency: +dev -> bit 0, -dev -> bit 1
        freq = mean_symbol_frequency(chunks, self.common.sample_rate)  # (..., H, B)
        flat = (freq < 0).to(SYMBOL_DTYPE).reshape(*freq.shape[:-2], -1)
        return DemodResult(
            bits=pack_demod_bits(flat),
            symbols=flat,
            metadata={
                "processing_gain_db": self.processing_gain_db(),
                "total_bandwidth": self.total_bandwidth(),
                "hop_rate": self.hop_rate,
                "hops_processed": float(n_hops),
            },
        )

    def hop_schedule(self, n_hops: int) -> np.ndarray:
        """(n_hops,) channel indices."""
        return self._channels_for(n_hops)


@register_waveform("FHSS")
def _fhss(sample_rate: float, device: torch.device) -> FHSS:
    return FHSS(common=CommonParams(sample_rate=sample_rate), device=device)


@dataclasses.dataclass(frozen=True)
class FhssAntiJam(FHSS):
    """Anti-jam FHSS: hops avoid a set of known-jammed channels by
    remapping onto the clean subset."""

    jammed_channels: tuple[int, ...] = ()

    def _channels_for(self, n_hops: int) -> np.ndarray:
        raw = super()._channels_for(n_hops)
        if not self.jammed_channels:
            return raw
        jammed = set(self.jammed_channels)
        clean = np.array([c for c in range(self.num_channels) if c not in jammed])
        if len(clean) == 0:
            raise ValueError("all channels jammed")
        return clean[raw % len(clean)]

    def info(self) -> WaveformInfo:
        base = super().info()
        return WaveformInfo(
            name="FHSS-AntiJam", full_name="Anti-jam FHSS",
            description="FHSS with jammed-channel avoidance",
            complexity=4, bits_per_symbol=1,
            characteristics=base.characteristics + (
                f"{len(self.jammed_channels)} channels excluded",
            ),
        )


@register_waveform("FHSS-AntiJam", aliases=("FHSSANTIJAM",))
def _fhss_antijam(sample_rate: float, device: torch.device) -> FhssAntiJam:
    return FhssAntiJam(common=CommonParams(sample_rate=sample_rate), device=device)
