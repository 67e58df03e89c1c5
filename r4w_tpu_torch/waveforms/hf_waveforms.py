"""HF link-establishment waveforms: ALE and 3G-ALE.

PyTorch counterpart of ``r4w_tpu.waveforms.hf_waveforms``: the 8-FSK ALE
tone alphabet with Golay-coded, triple-redundant 24-bit words, and the
3G-ALE burst 8PSK waveform, with the ALE and 3G-ALE word structures. The
tone correlator is an elementwise complex product summed over each
symbol, then the first maximum of its magnitude; the redundant copies of
all words are voted and Golay-decoded in one batched call.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams)
from r4w_tpu_torch.fec.block import golay_decode, golay_encode
from r4w_tpu_torch.ops.coding import bits_to_symbols, symbols_to_bits
from r4w_tpu_torch.ops.spreading import lfsr_bits
from r4w_tpu_torch.waveforms.base import (DemodResult, Waveform, WaveformInfo, as_iq,
                                          host_table, empty_result, register_waveform)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits
from r4w_tpu_torch.waveforms.simple_waveforms import padded_bits, symbol_blocks

CPU = torch.device("cpu")


def _carrier(n: int, freq: float, fs: float, device) -> torch.Tensor:
    ph = 2.0 * np.pi * freq / fs * torch.arange(n, dtype=REAL_DTYPE, device=device)
    return cis(ph).to(IQ_DTYPE)


@functools.lru_cache(maxsize=None)
def _scrambler(length: int, seed: int = 0xAB) -> np.ndarray:
    """8PSK scrambler symbols from an LFSR."""
    bits = lfsr_bits(8, 0x8E, seed, length=3 * length)
    tribits = bits[: 3 * length].reshape(length, 3)
    return (tribits[:, 0] * 4 + tribits[:, 1] * 2 + tribits[:, 2]).astype(np.int32)


class _SerialToneModem(Waveform):
    """Shared serial-tone PSK machinery: preamble + scrambled PSK data on
    an 1800 Hz carrier at 2400 baud."""

    # subclass attributes: name/full/desc, psk_order, preamble_len
    common: CommonParams
    device: torch.device
    carrier_freq = 1800.0
    symbol_rate = 2400.0
    psk_order = 8
    preamble_len = 80
    name = "HF"
    full_name = "HF serial modem"
    desc = ""

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return max(int(self.common.sample_rate / self.symbol_rate), 1)

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.psk_order))

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name=self.name, full_name=self.full_name, description=self.desc,
            complexity=4, bits_per_symbol=self.bits_per_symbol,
            characteristics=(f"{self.symbol_rate:.0f} Bd on "
                             f"{self.carrier_freq:.0f} Hz carrier",
                             f"{self.preamble_len}-symbol sync preamble"),
        )

    def _preamble_symbols(self) -> np.ndarray:
        return _scrambler(self.preamble_len, seed=0x5A)

    def _psk_points(self, device) -> torch.Tensor:
        ang = 2.0 * np.pi * np.arange(self.psk_order) / self.psk_order
        return host_table(np.exp(1j * ang).astype(np.complex64), device)

    def _symbols_to_iq(self, symbols: torch.Tensor) -> torch.Tensor:
        pts = self._psk_points(symbols.device)[symbols.long()]
        base = pts.repeat_interleave(self.samples_per_symbol(), dim=-1)
        car = _carrier(base.shape[-1], self.carrier_freq, self.common.sample_rate, base.device)
        return (self.common.amplitude * base * car).to(IQ_DTYPE)

    def modulate(self, data) -> torch.Tensor:
        bits = host_table(padded_bits(data, self.bits_per_symbol), self.device)
        dsyms = bits_to_symbols(bits, self.bits_per_symbol)
        dsyms = (dsyms + host_table(_scrambler(int(dsyms.shape[-1])), self.device)) % self.psk_order
        pre = host_table(self._preamble_symbols(), self.device)
        return self._symbols_to_iq(torch.cat([pre, dsyms]))

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        dev = samples.device
        sps = self.samples_per_symbol()
        n = samples.shape[-1]
        if n // sps <= self.preamble_len:
            return empty_result(dev)
        base = samples * torch.conj(_carrier(n, self.carrier_freq, self.common.sample_rate, dev))
        avg = torch.mean(symbol_blocks(base, sps), dim=-1)
        points = self._psk_points(dev)
        # phase reference from the known preamble
        pre = points[host_table(self._preamble_symbols(), dev).long()]
        ref = torch.sum(avg[..., : self.preamble_len] * torch.conj(pre), dim=-1)
        ref = ref / torch.clamp_min(torch.abs(ref), 1e-12)
        data = avg[..., self.preamble_len:] * torch.conj(ref[..., None])
        d = data[..., None] - points
        raw = torch.argmin(d.real ** 2 + d.imag ** 2, dim=-1).to(SYMBOL_DTYPE)
        scr = host_table(_scrambler(int(raw.shape[-1])), dev)
        symbols = (raw - scr) % self.psk_order
        bits = symbols_to_bits(symbols, self.bits_per_symbol)
        snr = float(-20.0 * torch.log10(torch.clamp_min(
            torch.mean(torch.abs(data - points[symbols.long()])), 1e-9)))
        return DemodResult(bits=pack_demod_bits(bits), symbols=symbols, snr_estimate=snr)


# --------------------------------------------------------------------- ALE

ALE_TONES = np.array([750.0 + 250.0 * i for i in range(8)])  # 750..2500 Hz


@dataclasses.dataclass(frozen=True)
class Ale(Waveform):
    """MIL-STD-188-141 ALE: 8-FSK at 125 baud, 24-bit words
    Golay(24,12)-encoded into 48 bits, each word sent `redundancy` times."""

    common: CommonParams = CommonParams(sample_rate=8000.0)
    baud: float = 125.0
    redundancy: int = 3
    device: torch.device = DEFAULT_DEVICE

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return int(self.common.sample_rate / self.baud)

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="ALE", full_name="Automatic Link Establishment",
            description="8-FSK 125 Bd with Golay-protected 24-bit words",
            complexity=4, bits_per_symbol=3,
            characteristics=("Tones 750-2500 Hz / 250 Hz spacing",
                             f"{self.redundancy}x word redundancy"),
        )

    def _word_symbols(self, words: np.ndarray) -> torch.Tensor:
        """(W, 24) data bits -> (W·48·redundancy/3,) tone indices on the
        device. The Golay encode runs on the host, as the reference's."""
        cw = golay_encode(torch.from_numpy(words.reshape(-1, 2, 12)), device=CPU)
        cw = cw.reshape(-1, 1, 48).repeat(1, self.redundancy, 1)  # (W, R, 48)
        return bits_to_symbols(cw.reshape(-1).to(self.device), 3)

    def modulate(self, data) -> torch.Tensor:
        words = padded_bits(data, 24).reshape(-1, 24)
        symbols = self._word_symbols(words)
        freqs = host_table(ALE_TONES.astype(np.float32), self.device)[symbols.long()]
        f_samp = freqs.repeat_interleave(self.samples_per_symbol())
        phase = 2.0 * np.pi * torch.cumsum(f_samp, dim=-1) / self.common.sample_rate
        return (self.common.amplitude * cis(phase)).to(IQ_DTYPE)

    def demodulate(self, samples) -> DemodResult:
        samples = as_iq(samples, self.device)
        dev = samples.device
        sps = self.samples_per_symbol()
        if samples.shape[-1] // sps == 0:
            return empty_result(dev)
        chunks = symbol_blocks(samples, sps)
        t = (torch.arange(sps, dtype=REAL_DTYPE, device=dev)
             / torch.tensor(self.common.sample_rate, dtype=REAL_DTYPE, device=dev))
        tones = host_table(ALE_TONES.astype(np.float32), dev)
        basis = cis(-2 * np.pi * tones[:, None] * t[None, :]).to(IQ_DTYPE)  # (8, sps)
        corr = torch.abs(torch.sum(chunks[..., None, :] * basis, dim=-1))  # (..., S, 8)
        symbols = torch.argmax(corr, dim=-1).to(SYMBOL_DTYPE)
        # majority vote over the redundant copies, then Golay decode, all words at once
        bits = symbols_to_bits(symbols, 3)
        word_bits = 48 * self.redundancy
        n_words = bits.shape[-1] // word_bits
        copies = bits[: n_words * word_bits].reshape(n_words, self.redundancy, 48)
        voted = (torch.sum(copies, dim=1, dtype=SYMBOL_DTYPE) * 2 > self.redundancy)
        data_bits, _ = golay_decode(voted.to(SYMBOL_DTYPE).reshape(n_words, 2, 24))
        return DemodResult(bits=pack_demod_bits(data_bits.reshape(-1)), symbols=symbols)


@dataclasses.dataclass(frozen=True)
class Ale3g(_SerialToneModem):
    """3G-ALE / MIL-STD-188-141B App C: burst PSK waveforms, modelled as
    the BW0-style 8PSK burst on 1800 Hz."""

    common: CommonParams = CommonParams(sample_rate=9600.0)
    preamble_len = 64
    name = "3G-ALE"
    full_name = "Third-Generation ALE (188-141B App C)"
    desc = "Burst 8PSK link-setup waveform (BW0-style burst)"
    amd_message: str = ""
    device: torch.device = DEFAULT_DEVICE


@register_waveform("ALE")
def _ale(sample_rate: float, device: torch.device) -> Ale:
    return Ale(common=CommonParams(sample_rate=max(sample_rate, 8000.0)), device=device)


@register_waveform("3G-ALE", aliases=("ALE3G", "MILSTD188141B"))
def _ale3g(sample_rate: float, device: torch.device) -> Ale3g:
    return Ale3g(common=CommonParams(sample_rate=max(sample_rate, 9600.0)), device=device)


# ------------------------------------------------- ALE word structure
#
# The real MIL-STD-188-141 24-bit word: 3-bit type preamble + three
# 7-bit ASCII characters (ale.rs:26-31 type table, ale.rs:149 AleWord).
# Characters come from the 38-symbol ALE subset (A-Z, 0-9, '@', '?').

ALE_WORD_TYPES = {
    "TO": 0b001, "TIS": 0b011, "TWAS": 0b010,
    "DATA": 0b101, "REP": 0b110, "CMD": 0b111,
}
ALE_TYPE_NAMES = {v: k for k, v in ALE_WORD_TYPES.items()}


@dataclasses.dataclass(frozen=True)
class AleWord:
    """One ALE word: type + 3 ASCII chars (ale.rs AleWord)."""

    word_type: str
    chars: str  # up to 3 characters

    def encode(self) -> int:
        """-> 24-bit value: type(3) | c0(7) | c1(7) | c2(7)."""
        v = ALE_WORD_TYPES[self.word_type] << 21
        padded = self.chars.upper().ljust(3, "@")[:3]
        for i, ch in enumerate(padded):
            v |= (ord(ch) & 0x7F) << (14 - 7 * i)
        return v

    @classmethod
    def decode(cls, value: int) -> "AleWord":
        t = (value >> 21) & 0x7
        if t not in ALE_TYPE_NAMES:
            raise ValueError(f"invalid ALE word type {t:#b}")
        chars = "".join(chr((value >> (14 - 7 * i)) & 0x7F)
                        for i in range(3))
        return cls(ALE_TYPE_NAMES[t], chars.rstrip("@"))

    def to_bits(self) -> np.ndarray:
        v = self.encode()
        return np.asarray([(v >> (23 - i)) & 1 for i in range(24)],
                          np.int32)

    @classmethod
    def from_bits(cls, bits24: np.ndarray) -> "AleWord":
        v = 0
        for b in np.asarray(bits24, np.int32)[:24]:
            v = (v << 1) | int(b)
        return cls.decode(v)


def ale_individual_call(to: str, this_is: str) -> list[AleWord]:
    """The standard individual-call frame: TO(addr) ×2 + TIS(addr)
    (141A calling cycle, single-channel short form)."""
    return [AleWord("TO", to[:3]), AleWord("TO", to[:3]),
            AleWord("TIS", this_is[:3])]


def ale_modulate_words(radio: Ale, words: list[AleWord]) -> torch.Tensor:
    """Send a word sequence through the 8-FSK PHY (each word
    Golay-protected + redundant as in Ale.modulate)."""
    bits = np.concatenate([w.to_bits() for w in words])
    return radio.modulate(bits.astype(np.int32))


def ale_demodulate_words(radio: Ale, samples) -> list[AleWord]:
    """Recover the word sequence; invalid words are dropped."""
    res = radio.demodulate(samples)
    bits = np.unpackbits(res.bits.cpu().numpy().astype(np.uint8))
    out = []
    for i in range(0, len(bits) - 23, 24):
        try:
            out.append(AleWord.from_bits(bits[i:i + 24]))
        except ValueError:
            continue
    return out


# ---------------------------------------------- 3G-ALE word structure
#
# ale3g.rs:66-115 extends the 2G table with AMD (0b100) and DTM header
# (0b000) types; AMD packs three 6-bit ASCII-subset characters per word
# (ale3g.rs:142-186), DTM fragments binary payloads.

ALE3G_WORD_TYPES = {**ALE_WORD_TYPES, "AMD": 0b100, "DTM": 0b000}
ALE3G_TYPE_NAMES = {v: k for k, v in ALE3G_WORD_TYPES.items()}
ALE3G_3G_SPECIFIC = ("AMD", "DTM")


def _amd_char_encode(ch: str) -> int:
    """6-bit ASCII subset: 0x20..0x5F -> 0..63 (ale3g.rs:148-153)."""
    v = ord(ch)
    return (v - 0x20) & 0x3F if 0x20 <= v <= 0x5F else 0


@dataclasses.dataclass
class AmdMessage:
    """Automatic Message Display: short text during linking
    (ale3g.rs:117)."""

    text: str
    priority: int = 0

    @classmethod
    def urgent(cls, text: str) -> "AmdMessage":
        return cls(text[:90], priority=3)

    def encode_words(self) -> list[int]:
        """-> list of 24-bit AMD word values (3 chars each)."""
        text = self.text[:90].upper()
        out = []
        for i in range(0, len(text), 3):
            chunk = text[i:i + 3].ljust(3)
            data = 0
            for j, ch in enumerate(chunk):
                data |= _amd_char_encode(ch) << (12 - 6 * j)
            out.append((ALE3G_WORD_TYPES["AMD"] << 21) | data)
        return out

    @classmethod
    def decode_words(cls, words: list[int]) -> "AmdMessage":
        text = []
        for w in words:
            if (w >> 21) & 0x7 != ALE3G_WORD_TYPES["AMD"]:
                continue
            for j in range(3):
                text.append(chr(((w >> (12 - 6 * j)) & 0x3F) + 0x20))
        return cls("".join(text).rstrip())


@dataclasses.dataclass
class DtmMessage:
    """Data Text Message: binary payload fragments (ale3g.rs:188)."""

    data: bytes
    sequence: int = 0
    final: bool = True

    @classmethod
    def fragment(cls, data: bytes, max_block: int = 64
                 ) -> list["DtmMessage"]:
        frags = []
        for i, start in enumerate(range(0, max(len(data), 1), max_block)):
            chunk = data[start:start + max_block]
            frags.append(cls(chunk, sequence=i,
                             final=start + max_block >= len(data)))
        return frags


def ale3g_lqa_score(ber: float, sinad_db: float) -> int:
    """Link-quality score 0-30 (ale3g.rs:316-348 Ale3gLqa): the better
    of each axis contributes up to 15."""
    ber_pts = int(np.clip(15.0 * (1.0 - min(ber, 0.1) / 0.1), 0, 15))
    snr_pts = int(np.clip(sinad_db / 2.0, 0, 15))
    return ber_pts + snr_pts


def ale3g_send_amd(radio: Ale, msg: AmdMessage) -> torch.Tensor:
    """AMD message over the 8-FSK PHY (the 3G tone waveform reuses the
    2G alphabet, ale3g.rs:38-50)."""
    words = msg.encode_words()
    bits = np.concatenate([
        np.asarray([(w >> (23 - i)) & 1 for i in range(24)], np.int32)
        for w in words])
    return radio.modulate(bits)


def ale3g_receive_amd(radio: Ale, samples) -> AmdMessage:
    res = radio.demodulate(samples)
    bits = np.unpackbits(res.bits.cpu().numpy().astype(np.uint8))
    words = []
    for i in range(0, len(bits) - 23, 24):
        v = 0
        for b in bits[i:i + 24]:
            v = (v << 1) | int(b)
        words.append(v)
    return AmdMessage.decode_words(words)
