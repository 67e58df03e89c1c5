"""Link-16 / JTIDS tactical data link: TDMA slot structure, CCSK,
RS(31,15), MSK double pulses.

PyTorch counterpart of ``r4w_tpu.waveforms.link16``, the same link maths:

* TDMA timing: 7.8125 ms slots, 128 slots/s, 1536 slots per 12.8 min
  frame (96 epochs × 16 slots).
* Pulses: a 13 µs window holds a 6.4 µs 32-chip burst at 5 Mchip/s.
  Double pulses carry each symbol twice on different hop frequencies. A
  packed-2 slot holds 258 pulses = 129 double pulses: 16 sync + 4 time
  refine + 16 header + 93 data.
* CCSK(32,5): each 5-bit symbol selects a cyclic shift of a 32-chip base
  sequence; the receiver correlates each pulse's soft chips against all
  32 shifts as an elementwise float32 product summed over the chips, and
  takes the first maximum.
* RS over GF(2^5) (`fec.galois`, on the host): data words RS(31,15),
  t = 8; the header a shortened RS(16,7) from RS(31,22), t = 4.
* J-series words: 70 payload bits each; one slot = 1 header word + 3 data
  words = 210 payload bits.
* TRANSEC seam: chip scrambling and the 51-frequency hop pattern come from
  a seeded simulator provider (`np.random.default_rng`), non-operational
  by construction.

The RF hop grid is scaled into the baseband sample rate.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, CommonParams
from r4w_tpu_torch.fec.galois import ReedSolomon
from r4w_tpu_torch.ops.spreading import lfsr_bits
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          data_to_bits, empty_result, register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits

CHIP_RATE = 5_000_000.0
CHIPS_PER_PULSE = 32
PULSE_ON_US = 6.4
PULSE_WINDOW_US = 13.0
SLOT_DURATION_US = 7812.5
SLOTS_PER_EPOCH = 16
EPOCHS_PER_FRAME = 96
SLOTS_PER_FRAME = SLOTS_PER_EPOCH * EPOCHS_PER_FRAME  # 1536
NUM_FREQUENCIES = 51
BASE_FREQ_HZ = 969e6
FREQ_SPACING_HZ = 3e6

SYNC_DP = 16
REFINE_DP = 4
HEADER_DP = 16
DATA_DP = 93  # 3 × RS(31,15) codewords
DP_PER_SLOT = SYNC_DP + REFINE_DP + HEADER_DP + DATA_DP  # 129
PULSES_PER_SLOT_P2 = 2 * DP_PER_SLOT  # 258

HEADER_BITS = 35          # 7 × 5-bit symbols
WORD_PAYLOAD_BITS = 70    # per J-series data word
WORDS_PER_SLOT = 3
SLOT_PAYLOAD_BITS = WORDS_PER_SLOT * WORD_PAYLOAD_BITS  # 210

# Fixed sync symbol pattern (values 0..31 — known CCSK shifts). The
# refine pulses repeat the last sync value.
SYNC_SYMBOLS = (0, 27, 9, 18, 4, 31, 13, 22, 2, 29, 11, 16, 6, 25, 15, 20)
REFINE_SYMBOLS = (7, 24, 7, 24)


@functools.lru_cache(maxsize=None)
def ccsk_base() -> np.ndarray:
    """Public 32-chip CCSK base sequence in {0,1}: degree-5 m-sequence
    x^5+x^3+1 (mask 0b10100) from all-ones, + one balancing zero chip."""
    bits = lfsr_bits(5, 0b10100, 0x1F, length=31)
    return np.concatenate([bits.astype(np.int32), [0]])


@functools.lru_cache(maxsize=None)
def ccsk_table() -> np.ndarray:
    """(32, 32) chips in ±1: row k = base cyclically left-shifted by k."""
    base = 1.0 - 2.0 * ccsk_base()  # bit 0 -> +1
    return np.stack([np.roll(base, -k) for k in range(32)]).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _rs_data() -> ReedSolomon:
    return ReedSolomon(31, 15, m=5)


@functools.lru_cache(maxsize=None)
def _rs_header() -> ReedSolomon:
    return ReedSolomon(31, 22, m=5)  # shortened to (16, 7)


def rs_encode_data(symbols15: np.ndarray) -> np.ndarray:
    """RS(31,15) encode one data word (15 five-bit symbols -> 31)."""
    return np.asarray(_rs_data().encode(symbols15), np.int32)


def rs_decode_data(symbols31: np.ndarray) -> tuple[np.ndarray, int]:
    return _rs_data().decode(symbols31)


def rs_encode_header(symbols7: np.ndarray) -> np.ndarray:
    """Shortened RS(16,7): encode [0]*15 + data under RS(31,22), then
    drop the 15 leading known zeros."""
    full = np.concatenate([np.zeros(15, np.int32),
                           np.asarray(symbols7, np.int32)])
    return np.asarray(_rs_header().encode(full), np.int32)[15:]


def rs_decode_header(symbols16: np.ndarray) -> tuple[np.ndarray, int]:
    full = np.concatenate([np.zeros(15, np.int32),
                           np.asarray(symbols16, np.int32)])
    dec, n = _rs_header().decode(full)
    return dec[15:], n


@functools.lru_cache(maxsize=None)
def data_interleave_pattern() -> np.ndarray:
    """Fixed symbol interleaver over the 93 data symbols: stride
    permutation i -> (32·i) mod 93 (gcd(32,93)=1, spreads each RS
    codeword's symbols across the slot so pulse-burst hits split
    between codewords)."""
    return ((32 * np.arange(DATA_DP)) % DATA_DP).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SimulatorTransec:
    """NON-OPERATIONAL TRANSEC: seeded chip scrambler + hop pattern
    (link16/simulator.rs SimulatorHoppingPattern / SimulatorTransec)."""

    seed: int = 0x116

    def chip_scramble(self, n_pulses: int) -> np.ndarray:
        """(n_pulses, 32) scramble chips in ±1."""
        rng = np.random.default_rng(self.seed ^ 0xC417)
        return (1.0 - 2.0 * rng.integers(
            0, 2, (n_pulses, CHIPS_PER_PULSE))).astype(np.float32)

    def hop_indices(self, n_pulses: int) -> np.ndarray:
        """Frequency index 0..50 per pulse; double-pulse halves get
        distinct frequencies."""
        rng = np.random.default_rng(self.seed)
        idx = rng.integers(0, NUM_FREQUENCIES, n_pulses)
        # ensure pulse pairs differ (diversity): bump equal seconds
        idx[1::2] = np.where(idx[1::2] == idx[::2],
                             (idx[1::2] + 7) % NUM_FREQUENCIES, idx[1::2])
        return idx


@dataclasses.dataclass(frozen=True)
class Link16(Waveform):
    """Link-16 STDP (packed-2) slot waveform with CCSK and RS coding."""

    common: CommonParams = CommonParams(sample_rate=10_000_000.0)
    seed: int = 0x116
    device: torch.device = DEFAULT_DEVICE

    name = "Link-16"

    @property
    def common_params(self) -> CommonParams:
        return self.common

    @property
    def samples_per_chip(self) -> int:
        return max(int(round(self.common.sample_rate / CHIP_RATE)), 1)

    @property
    def burst_samples(self) -> int:
        return CHIPS_PER_PULSE * self.samples_per_chip

    @property
    def pulse_window_samples(self) -> int:
        return int(round(PULSE_WINDOW_US * 1e-6 * self.common.sample_rate))

    @property
    def slot_samples(self) -> int:
        return int(round(SLOT_DURATION_US * 1e-6 * self.common.sample_rate))

    def samples_per_symbol(self) -> int:
        return 2 * self.pulse_window_samples  # one double pulse

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name=self.name,
            full_name="Link-16 / JTIDS tactical data link",
            description="TDMA slots: CCSK(32,5) MSK double pulses, "
                        "RS(31,15) data words, RS(16,7) header",
            complexity=5,
            bits_per_symbol=5,
            characteristics=(
                "7.8125 ms slots, 258 pulses packed-2",
                "51-frequency hop set (scaled to baseband)",
                "RS(31,15) over GF(32), t=8",
                "TRANSEC/hop pattern: simulator only",
            ),
        )

    # ------------------------------------------------------------ link

    def slot_symbols(self, payload_bits: np.ndarray) -> np.ndarray:
        """One slot's 129 double-pulse symbol values (0..31) from exactly
        210 payload bits (3 J-words × 70)."""
        if payload_bits.size != SLOT_PAYLOAD_BITS:
            raise ValueError(f"a slot carries {SLOT_PAYLOAD_BITS} bits, got {payload_bits.size}")
        words = payload_bits.reshape(WORDS_PER_SLOT, WORD_PAYLOAD_BITS)
        data_syms = []
        for w in words:
            padded = np.concatenate([w, np.zeros(5, np.int32)])  # 75 bits
            syms15 = padded.reshape(15, 5) @ (1 << np.arange(4, -1, -1))
            data_syms.append(rs_encode_data(syms15.astype(np.int32)))
        data93 = np.concatenate(data_syms)[data_interleave_pattern()]

        hdr_bits = np.zeros(HEADER_BITS, np.int32)
        hdr_bits[:8] = (np.arange(8) + 1) % 2  # message label placeholder
        hdr7 = (hdr_bits.reshape(7, 5) @ (1 << np.arange(4, -1, -1))).astype(np.int32)
        hdr16 = rs_encode_header(hdr7)

        return np.concatenate([np.asarray(SYNC_SYMBOLS, np.int32),
                               np.asarray(REFINE_SYMBOLS, np.int32), hdr16, data93])

    def _pulse_freq_offsets(self, n_pulses: int) -> np.ndarray:
        """Hop frequencies scaled into baseband: the grid spans ±0.4·fs."""
        idx = SimulatorTransec(self.seed).hop_indices(n_pulses)
        spacing = 0.8 * self.common.sample_rate / NUM_FREQUENCIES
        return ((idx - NUM_FREQUENCIES // 2) * spacing).astype(np.float64)

    def _pulse_carriers(self, n_slots: int, sign: float, device) -> torch.Tensor:
        """(n_slots·258, burst_samples) unit phasors of each pulse's hop
        frequency, float32 phase 2π·f·t as the reference computes it."""
        freqs = np.tile(self._pulse_freq_offsets(PULSES_PER_SLOT_P2), n_slots)
        f = torch.from_numpy(freqs.astype(np.float32)).to(device)
        t = (torch.arange(self.burst_samples, dtype=REAL_DTYPE, device=device)
             / torch.tensor(self.common.sample_rate, dtype=REAL_DTYPE, device=device))
        return cis(sign * 2 * np.pi * f[:, None] * t[None, :])

    def _scramble(self, n_slots: int, device) -> torch.Tensor:
        scr = SimulatorTransec(self.seed).chip_scramble(PULSES_PER_SLOT_P2)
        return torch.from_numpy(np.tile(scr, (n_slots, 1))).to(device)

    def modulate(self, data) -> torch.Tensor:
        bits = data_to_bits(data)
        n_slots = -(-max(bits.size, 1) // SLOT_PAYLOAD_BITS)
        bits = np.pad(bits, (0, n_slots * SLOT_PAYLOAD_BITS - bits.size))

        dp_syms = np.concatenate([
            self.slot_symbols(bits[s * SLOT_PAYLOAD_BITS:(s + 1) * SLOT_PAYLOAD_BITS])
            for s in range(n_slots)
        ])  # (n_slots·129,)
        pulse_syms = np.repeat(dp_syms, 2)  # double pulse
        n_pulses = pulse_syms.size

        dev = self.device
        # TRANSEC scramble and hop patterns repeat per slot (the simulator
        # provider is slot-relative)
        chips = torch.from_numpy(ccsk_table()[pulse_syms]).to(dev) * self._scramble(n_slots, dev)
        spc = self.samples_per_chip
        # MSK: the phase advances ±π/2 per chip
        dphi = chips.repeat_interleave(spc, dim=-1) * (np.pi / 2.0 / spc)
        burst = cis(torch.cumsum(dphi, dim=-1)) * self._pulse_carriers(n_slots, 1.0, dev)

        win = self.pulse_window_samples
        pulses = torch.zeros((n_pulses, win), dtype=IQ_DTYPE, device=dev)
        pulses[:, : self.burst_samples] = burst
        # the propagation guard fills the rest of each 7.8125 ms slot
        per_slot_used = PULSES_PER_SLOT_P2 * win
        out = torch.zeros((n_slots, self.slot_samples), dtype=IQ_DTYPE, device=dev)
        out[:, :per_slot_used] = pulses.reshape(n_slots, per_slot_used)
        return (self.common.amplitude * out.reshape(-1)).to(IQ_DTYPE)

    # ------------------------------------------------------------- RX

    def _correlate_pulses(self, slots_iq: torch.Tensor) -> torch.Tensor:
        """(n_slots, slot_samples) -> (n_slots, 129, 32) double-pulse CCSK
        correlations, the two pulses of each pair summed."""
        dev = slots_iq.device
        win = self.pulse_window_samples
        spc = self.samples_per_chip
        n_slots = slots_iq.shape[0]
        body = slots_iq[:, : PULSES_PER_SLOT_P2 * win].reshape(n_slots * PULSES_PER_SLOT_P2, win)
        burst = body[:, : self.burst_samples] * self._pulse_carriers(n_slots, -1.0, dev)

        # MSK chip detection: the phase step across each chip interval
        ref = torch.cat([torch.ones_like(burst[:, :1]), burst[:, :-1]], dim=1)
        inc = torch.angle(burst * torch.conj(ref))  # (P, burst_samples)
        chip_soft = torch.sum(inc.reshape(-1, CHIPS_PER_PULSE, spc), dim=-1)  # ~ ±π/2 a chip
        chip_soft = chip_soft * self._scramble(n_slots, dev)  # descramble

        table = torch.from_numpy(ccsk_table()).to(dev)  # (32 shifts, 32 chips)
        corr = torch.sum(chip_soft[:, None, :] * table, dim=-1)  # (P, 32)
        return torch.sum(corr.reshape(n_slots, DP_PER_SLOT, 2, 32), dim=2)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        n_slots = int(samples.shape[-1]) // self.slot_samples
        if n_slots == 0:
            return empty_result(samples.device)
        slots_iq = samples[: n_slots * self.slot_samples].reshape(n_slots, self.slot_samples)
        syms = torch.argmax(self._correlate_pulses(slots_iq), dim=-1).cpu().numpy()

        sync_ok = (syms[:, :SYNC_DP] == np.asarray(SYNC_SYMBOLS)[None, :]).mean()
        inv = np.argsort(data_interleave_pattern())

        # the RS decoders run on the host
        out_bits, corrected = [], 0
        for s in range(n_slots):
            # the header is decoded as the reference decodes it; it carries no payload
            rs_decode_header(syms[s, SYNC_DP + REFINE_DP:SYNC_DP + REFINE_DP + HEADER_DP])
            data93 = syms[s, SYNC_DP + REFINE_DP + HEADER_DP:][inv]
            for w in range(WORDS_PER_SLOT):
                dec, n_corr = rs_decode_data(data93[w * 31:(w + 1) * 31])
                corrected += max(n_corr, 0)
                word_bits = ((dec[:, None] >> np.arange(4, -1, -1)) & 1).reshape(-1)  # 75 bits
                out_bits.append(word_bits[:WORD_PAYLOAD_BITS])
        bits = torch.from_numpy(np.concatenate(out_bits).astype(np.int32)).to(samples.device)
        return DemodResult(
            bits=pack_demod_bits(bits),
            symbols=torch.from_numpy(syms.reshape(-1).astype(np.int32)).to(samples.device),
            metadata={"sync_fraction": float(sync_ok),
                      "rs_symbols_corrected": int(corrected),
                      "slots": n_slots})

    def get_modulation_stages(self, data):
        bits = data_to_bits(data)
        pad = (-bits.size) % SLOT_PAYLOAD_BITS
        slot0 = self.slot_symbols(np.pad(bits, (0, pad))[:SLOT_PAYLOAD_BITS])
        return [("input bits", bits),
                ("slot 0 double-pulse symbols", slot0),
                ("modulated IQ", self.modulate(data))]


@register_waveform("Link-16", aliases=("TADILJ", "MIDS", "JTIDS"))
def _link16(sample_rate: float, device: torch.device) -> Link16:
    return Link16(common=CommonParams(sample_rate=max(sample_rate, 1e7)), device=device)
