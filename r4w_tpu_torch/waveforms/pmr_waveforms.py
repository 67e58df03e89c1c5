"""PMR / public-safety waveforms: P25 (C4FM and Phase 2), TETRA
(π/4-DQPSK) and DMR (4FSK).

PyTorch counterpart of ``r4w_tpu.waveforms.pmr_waveforms``: two batched
cores, continuous-phase 4-level FSK (C4FM, DMR) and differentially
encoded π/4-DQPSK (TETRA, P25 Phase 2), and P25's framing on the first:
the 48-bit frame sync and the NID (NAC and DUID) protected by
BCH(63,16), t = 11, whose codec runs on the host (`fec.galois`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, SYMBOL_DTYPE, CommonParams
from r4w_tpu_torch.fec.galois import BCH
from r4w_tpu_torch.ops.coding import bits_to_symbols, symbols_to_bits
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          host_table, empty_result, register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits
from r4w_tpu_torch.waveforms.simple_waveforms import (mean_symbol_frequency, padded_bits,
                                                      phase_accumulate, symbol_blocks)

# dibit -> deviation order used by P25/DMR: 01,00,10,11 -> +3,+1,-1,-3
_FOUR_LEVEL = {0b01: 3, 0b00: 1, 0b10: -1, 0b11: -3}
_FOUR_LEVEL_LUT = np.array([_FOUR_LEVEL[v] for v in range(4)], np.float32)


@dataclasses.dataclass(frozen=True)
class FourLevelFsk(Waveform):
    """Shared C4FM/4FSK core: dibits -> ±1/±3 × deviation, continuous phase."""

    common: CommonParams = CommonParams(sample_rate=48_000.0)
    symbol_rate: float = 4800.0
    deviation_unit: float = 600.0  # Hz per level unit (P25: ±600/±1800)
    name_: str = "C4FM"
    full_name_: str = "4-level continuous FSK"
    desc_: str = ""
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return max(int(self.common.sample_rate / self.symbol_rate), 1)

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name=self.name_, full_name=self.full_name_,
            description=self.desc_, complexity=3, bits_per_symbol=2,
            characteristics=(
                f"{self.symbol_rate:.0f} Bd, deviations "
                f"±{self.deviation_unit:.0f}/±{3*self.deviation_unit:.0f} Hz",
            ),
        )

    def modulate(self, data) -> torch.Tensor:
        dibits = bits_to_symbols(host_table(padded_bits(data, 2), self.device), 2)
        levels = host_table(_FOUR_LEVEL_LUT, self.device)[dibits.long()]
        freq = (levels * self.deviation_unit).repeat_interleave(self.samples_per_symbol())
        omega = 2.0 * np.pi * freq / self.common.sample_rate
        return (self.common.amplitude * cis(phase_accumulate(omega))).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        sps = self.samples_per_symbol()
        if samples.shape[-1] // sps == 0:
            return empty_result(samples.device)
        freq = mean_symbol_frequency(symbol_blocks(samples, sps), self.common.sample_rate)
        lv = freq / self.deviation_unit
        lut = host_table(_FOUR_LEVEL_LUT, samples.device)
        dibits = torch.argmin(torch.abs(lv[..., None] - lut), dim=-1).to(SYMBOL_DTYPE)
        return DemodResult(bits=pack_demod_bits(symbols_to_bits(dibits, 2)), symbols=dibits)


@dataclasses.dataclass(frozen=True)
class Pi4Dqpsk(Waveform):
    """π/4-DQPSK core (TETRA, P25 Phase 2): dibits -> differential phase
    steps ±π/4, ±3π/4."""

    common: CommonParams = CommonParams(sample_rate=72_000.0)
    symbol_rate: float = 18_000.0
    name_: str = "TETRA"
    full_name_: str = "pi/4-DQPSK"
    desc_: str = ""
    device: torch.device = DEFAULT_DEVICE

    _STEPS = (np.pi / 4, 3 * np.pi / 4, -np.pi / 4, -3 * np.pi / 4)

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return max(int(self.common.sample_rate / self.symbol_rate), 1)

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name=self.name_, full_name=self.full_name_,
            description=self.desc_, complexity=3, bits_per_symbol=2,
            characteristics=("Differential ±π/4, ±3π/4 phase steps",
                             f"{self.symbol_rate/1e3:.0f} kBd"),
        )

    def _steps(self, device) -> torch.Tensor:
        return host_table(np.asarray(self._STEPS, np.float32), device)

    def modulate(self, data) -> torch.Tensor:
        dibits = bits_to_symbols(host_table(padded_bits(data, 2), self.device), 2)
        steps = self._steps(self.device)[dibits.long()]
        # the differential reference symbol at phase 0 leads the burst
        phase = torch.cat([torch.zeros(1, dtype=steps.dtype, device=self.device),
                           torch.cumsum(steps, dim=-1)])
        pts = cis(phase)
        return (self.common.amplitude
                * pts.repeat_interleave(self.samples_per_symbol(), dim=-1)).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        sps = self.samples_per_symbol()
        if samples.shape[-1] // sps < 2:
            return empty_result(samples.device)
        avg = torch.mean(symbol_blocks(samples, sps), dim=-1)
        dphase = torch.angle(avg[..., 1:] * torch.conj(avg[..., :-1]))
        err = torch.abs(torch.remainder(dphase[..., None] - self._steps(samples.device) + np.pi,
                                        2 * np.pi) - np.pi)
        dibits = torch.argmin(err, dim=-1).to(SYMBOL_DTYPE)
        return DemodResult(bits=pack_demod_bits(symbols_to_bits(dibits, 2)), symbols=dibits)


# ------------------------------------------------------- P25 framing

P25_FRAME_SYNC = 0x5575F5FF77FF  # 48 bits = 24 dibits
P25_DEFAULT_NAC = 0x293

P25_DUIDS = {
    "HDU": 0x0, "TDU": 0x3, "LDU1": 0x5, "TSBK": 0x7,
    "LDU2": 0xA, "PDU": 0xC, "TDULC": 0xF,
}
P25_DUID_NAMES = {v: k for k, v in P25_DUIDS.items()}


def p25_sync_dibits() -> np.ndarray:
    """The 24 frame-sync dibits, MSB first."""
    return np.asarray([(P25_FRAME_SYNC >> (46 - 2 * i)) & 0x3 for i in range(24)], np.int32)


@functools.lru_cache(maxsize=None)
def _nid_bch() -> BCH:
    return BCH(m=6, t=11)  # BCH(63,16): the P25 NID code


def p25_encode_nid(nac: int, duid: int) -> np.ndarray:
    """NID: 16 bits (NAC << 4 | DUID) -> BCH(63,16) + 1 pad bit = 64 bits
    = 32 dibits."""
    word = ((nac & 0xFFF) << 4) | (duid & 0xF)
    bits16 = np.asarray([(word >> (15 - i)) & 1 for i in range(16)], np.int32)
    cw = np.asarray(_nid_bch().encode(bits16), np.int32)
    return np.concatenate([cw, [0]])  # pad to 64 bits


def p25_decode_nid(bits64: np.ndarray) -> tuple[int, int, int]:
    """-> (nac, duid, n_corrected); n_corrected = -1 on decode failure."""
    dec, n = _nid_bch().decode(np.asarray(bits64[:63], np.int32))
    word = 0
    for b in np.asarray(dec)[:16]:
        word = (word << 1) | int(b)
    return (word >> 4) & 0xFFF, word & 0xF, n


@dataclasses.dataclass(frozen=True)
class P25(FourLevelFsk):
    """P25 Phase 1 C4FM with framing: frame sync + BCH-coded NID + payload."""

    nac: int = P25_DEFAULT_NAC
    duid: str = "PDU"

    def frame_dibits(self, data) -> torch.Tensor:
        payload = bits_to_symbols(torch.from_numpy(padded_bits(data, 2)), 2).numpy()
        nid_bits = p25_encode_nid(self.nac, P25_DUIDS[self.duid])
        nid_dibits = nid_bits.reshape(32, 2) @ np.asarray([2, 1])
        return host_table(np.concatenate([p25_sync_dibits(), nid_dibits.astype(np.int32), payload]),
                      self.device)

    def modulate(self, data) -> torch.Tensor:
        return self._dibits_to_iq(self.frame_dibits(data))

    def _dibits_to_iq(self, dibits: torch.Tensor) -> torch.Tensor:
        return super().modulate(symbols_to_bits(dibits, 2).cpu().numpy())

    def demodulate(self, samples) -> DemodResult:
        res = super().demodulate(samples)
        dibits = res.symbols.cpu().numpy()
        if dibits.shape[-1] < 56:
            return res
        # locate the sync by an exact-match search over the first symbols
        sync = p25_sync_dibits()
        best, best_off = -1, 0
        for off in range(min(200, dibits.shape[-1] - 56) + 1):
            score = int((dibits[off:off + 24] == sync).sum())
            if score > best:
                best, best_off = score, off
        if best < 20:  # sync not present
            return res
        nid_dibits = dibits[best_off + 24:best_off + 56]
        nid_bits = np.stack([(nid_dibits >> 1) & 1, nid_dibits & 1], axis=-1).reshape(-1)
        nac, duid, n_corr = p25_decode_nid(nid_bits)
        payload = res.symbols[best_off + 56:]
        return DemodResult(
            bits=pack_demod_bits(symbols_to_bits(payload, 2)), symbols=res.symbols,
            metadata={"nac": nac,
                      "duid": P25_DUID_NAMES.get(duid, f"0x{duid:X}"),
                      "nid_corrected": n_corr,
                      "sync_errors": 24 - best})


@register_waveform("P25", aliases=("APCO25", "APCOP25"))
def _p25(sample_rate: float, device: torch.device) -> P25:
    return P25(
        common=CommonParams(sample_rate=max(sample_rate, 48_000.0)),
        symbol_rate=4800.0, deviation_unit=600.0,
        name_="P25", full_name_="APCO Project 25 Phase 1 (C4FM)",
        desc_="4.8 kBd C4FM with frame sync + BCH(63,16) NID", device=device,
    )


@register_waveform("P25-Phase2", aliases=("P25PHASE2", "P25P2"))
def _p25p2(sample_rate: float, device: torch.device) -> Pi4Dqpsk:
    return Pi4Dqpsk(
        common=CommonParams(sample_rate=max(sample_rate, 48_000.0)),
        symbol_rate=6000.0,
        name_="P25-Phase2", full_name_="APCO P25 Phase 2 (H-DQPSK)",
        desc_="6 kBd differential QPSK TDMA voice", device=device,
    )


@register_waveform("TETRA")
def _tetra(sample_rate: float, device: torch.device) -> Pi4Dqpsk:
    return Pi4Dqpsk(
        common=CommonParams(sample_rate=max(sample_rate, 72_000.0)),
        symbol_rate=18_000.0,
        name_="TETRA", full_name_="TETRA TMO pi/4-DQPSK",
        desc_="18 kBd trunked emergency-services radio", device=device,
    )


@register_waveform("TETRA-DMO", aliases=("TETRADMO",))
def _tetra_dmo(sample_rate: float, device: torch.device) -> Pi4Dqpsk:
    return Pi4Dqpsk(
        common=CommonParams(sample_rate=max(sample_rate, 72_000.0)),
        symbol_rate=18_000.0,
        name_="TETRA-DMO", full_name_="TETRA Direct Mode",
        desc_="Direct mode pi/4-DQPSK", device=device,
    )


@register_waveform("DMR", aliases=("DMRTIER2",))
def _dmr(sample_rate: float, device: torch.device) -> FourLevelFsk:
    return FourLevelFsk(
        common=CommonParams(sample_rate=max(sample_rate, 48_000.0)),
        symbol_rate=4800.0, deviation_unit=648.0,
        name_="DMR", full_name_="Digital Mobile Radio Tier II (4FSK)",
        desc_="4.8 kBd 4FSK, ±648/±1944 Hz deviations", device=device,
    )


@register_waveform("DMR-Tier3", aliases=("DMRTIER3",))
def _dmr3(sample_rate: float, device: torch.device) -> FourLevelFsk:
    return FourLevelFsk(
        common=CommonParams(sample_rate=max(sample_rate, 48_000.0)),
        symbol_rate=4800.0, deviation_unit=648.0,
        name_="DMR-Tier3", full_name_="DMR Tier III trunked",
        desc_="Trunked-mode DMR 4FSK", device=device,
    )


@register_waveform("DMR-Direct", aliases=("DMRDIRECT",))
def _dmr_direct(sample_rate: float, device: torch.device) -> FourLevelFsk:
    return FourLevelFsk(
        common=CommonParams(sample_rate=max(sample_rate, 48_000.0)),
        symbol_rate=4800.0, deviation_unit=648.0,
        name_="DMR-Direct", full_name_="DMR direct (simplex) mode",
        desc_="DMR dual-capacity direct mode", device=device,
    )
