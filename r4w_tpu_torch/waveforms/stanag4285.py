"""STANAG 4285 NATO HF serial-tone modem with conformant framing.

PyTorch counterpart of ``r4w_tpu.waveforms.stanag4285``, with the same
frame and the same receiver:

* 2400 Bd serial tone on an 1800 Hz carrier.
* 256-symbol frame = 80-symbol sync preamble + 176 symbols in four
  32-symbol data blocks separated by three 16-symbol probe blocks.
* Preamble: 80 BPSK symbols of the degree-5 m-sequence x^5 + x^2 + 1
  (init all ones), 31 chips tiled to 80.
* The 176 data and probe symbols of every frame are scrambled by adding
  (mod 8) 3-bit groups of the 9-bit LFSR x^9 + x^4 + 1 seeded 0x1FF,
  restarted each frame. Probes are index 0 before scrambling, so the
  on-air probe is the scrambler itself, known at the receiver.
* FEC: K=7 rate-1/2 convolutional code (0o171/0o133), soft-decision
  Viterbi (`fec.convolutional`: both Hopper kernels on a CUDA tensor,
  one lane per burst).
* User rates 75..3600 bps by repetition and modulation: 75/150/300/600
  BPSK (×8/×4/×2/×1), 1200 QPSK, 2400 8PSK, 3600 uncoded 8PSK.
* Block interleaver over whole spans, short = 8 frames, long = 96
  frames of coded bits, written row-wise into 32 columns and read
  column-wise. Inverse permutations are built on the host.

The receiver equalises every frame at once from its anchors (the
preamble's least-squares gain and the three probe blocks'), linearly
interpolated over the frame with the searchsorted lerp of
`serial_tone.interp`, then demaps, deinterleaves and decodes the whole
burst in one Viterbi call. The carrier phase is float32 2π·f/fs times a
float32 sample index, as the reference computes it. The 8PSK points and
the index tables are MIL-STD-188-110's (the same grid).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from r4w_tpu_torch.core.types import (DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE,
                                      CommonParams)
from r4w_tpu_torch.fec.convolutional import conv_encode, viterbi_decode
from r4w_tpu_torch.ops.modem import soft_demap_llr
from r4w_tpu_torch.ops.spreading import lfsr_bits
from r4w_tpu_torch.waveforms.base import (
    DemodResult,
    Waveform,
    WaveformInfo,
    data_to_bits,
    register_waveform,
)
from r4w_tpu_torch.waveforms.linear_mod import pack_demod_bits
from r4w_tpu_torch.waveforms.serial_tone import _index, _psk8, interp

SYMBOL_RATE = 2400.0
CARRIER_HZ = 1800.0
FRAME_SYMS = 256
PREAMBLE_SYMS = 80
DATA_SYMS_PER_FRAME = 128  # 4 × 32
PROBE_SYMS_PER_FRAME = 48  # 3 × 16
CONV_POLYS = (0o171, 0o133)

# Mode table: user bps -> (bits/symbol, repetition, convolutional?)
MODES: dict[int, tuple[int, int, bool]] = {
    75: (1, 8, True),
    150: (1, 4, True),
    300: (1, 2, True),
    600: (1, 1, True),
    1200: (2, 1, True),
    2400: (3, 1, True),
    3600: (3, 1, False),
}

# Gray maps: bits value -> 8PSK constellation index (multiples of 8/M)
_GRAY_TO_INDEX = {
    1: np.array([0, 4], np.int32),                      # BPSK: 0, π
    2: np.array([0, 2, 6, 4], np.int32),                # QPSK Gray 00,01,10,11
    3: np.array([0, 1, 3, 2, 7, 6, 4, 5], np.int32),    # 8PSK Gray
}


@functools.lru_cache(maxsize=None)
def preamble_indices() -> np.ndarray:
    """80 preamble symbols as 8PSK indices {0,4} (BPSK on the 8PSK grid):
    the m-sequence x^5+x^2+1 (taps mask 0b10010), init 11111, 31 chips
    tiled to 80."""
    bits = lfsr_bits(5, 0b10010, 0x1F, length=31)
    tiled = np.tile(bits, 3)[:PREAMBLE_SYMS]
    return (tiled.astype(np.int32) * 4).astype(np.int32)


@functools.lru_cache(maxsize=None)
def frame_scrambler() -> np.ndarray:
    """176 scrambler values in 0..7 (one frame), x^9+x^4+1 from 0x1FF
    (taps mask 0b100001000: feedback = s[8] ^ s[3])."""
    bits = lfsr_bits(9, 0b100001000, 0x1FF, length=3 * (FRAME_SYMS - PREAMBLE_SYMS))
    tri = bits.astype(np.int32).reshape(-1, 3)
    return tri[:, 0] * 4 + tri[:, 1] * 2 + tri[:, 2]


@functools.lru_cache(maxsize=None)
def _frame_layout() -> tuple[np.ndarray, np.ndarray]:
    """(data_pos, probe_pos) within the 176 post-preamble frame symbols:
    32 data, 16 probe, 32 data, 16 probe, 32 data, 16 probe, 32 data."""
    pos = []
    probe = []
    cursor = 0
    for blk in range(4):
        pos.extend(range(cursor, cursor + 32))
        cursor += 32
        if blk < 3:
            probe.extend(range(cursor, cursor + 16))
            cursor += 16
    if cursor != FRAME_SYMS - PREAMBLE_SYMS:
        raise AssertionError(f"frame layout covers {cursor} symbols")
    return np.asarray(pos, np.int32), np.asarray(probe, np.int32)


def interleaver_shape(mode_bps: int, long_interleave: bool) -> tuple[int, int]:
    """(rows, cols) of the block interleaver; rows·cols = coded bits per
    span (8 or 96 frames of data symbols), cols fixed at 32."""
    bps = MODES[mode_bps][0]
    frames = 96 if long_interleave else 8
    span_bits = frames * DATA_SYMS_PER_FRAME * bps
    cols = 32
    return span_bits // cols, cols


@functools.lru_cache(maxsize=None)
def interleave_permutation(rows: int, cols: int) -> np.ndarray:
    """out[j] = in[perm[j]] for one span (row-write, column-read)."""
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    return idx.T.reshape(-1).astype(np.int32)


def _carrier(n: int, sample_rate: float, device: torch.device) -> torch.Tensor:
    """exp(j·φ[i]), φ[i] = float32(2π·f/fs) · i in float32."""
    step = torch.tensor(2.0 * math.pi * CARRIER_HZ / sample_rate, dtype=REAL_DTYPE)
    ph = step.to(device) * torch.arange(n, dtype=REAL_DTYPE, device=device)
    return torch.complex(torch.cos(ph), torch.sin(ph))


@dataclasses.dataclass(frozen=True)
class Stanag4285(Waveform):
    """STANAG 4285 HF modem with conformant 256-symbol framing."""

    common: CommonParams = CommonParams(sample_rate=9600.0)
    mode_bps: int = 2400
    long_interleave: bool = False
    device: torch.device = DEFAULT_DEVICE

    name = "STANAG-4285"

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return max(int(round(self.common.sample_rate / SYMBOL_RATE)), 1)

    @property
    def bits_per_symbol(self) -> int:
        return MODES[self.mode_bps][0]

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name=self.name,
            full_name="NATO STANAG 4285 HF modem",
            description="Serial-tone PSK on 1800 Hz, 256-symbol frames "
                        "(80 sync + 4×32 data + 3×16 probe)",
            complexity=4,
            bits_per_symbol=self.bits_per_symbol,
            characteristics=(
                "2400 Bd on 1800 Hz carrier",
                f"{self.mode_bps} bps, "
                f"{'long' if self.long_interleave else 'short'} interleave",
                "K=7 rate-1/2 convolutional FEC (0o171/0o133)",
                "Scrambled 8PSK symbol grid, known probes",
            ),
        )

    # ------------------------------------------------------------- TX

    def _coded_bits(self, bits: np.ndarray) -> torch.Tensor:
        _, rep, coded = MODES[self.mode_bps]
        b = torch.from_numpy(np.asarray(bits, np.int32)).to(self.device)
        if coded:
            b = conv_encode(b, 7, CONV_POLYS, terminate=True)
        return b.repeat_interleave(rep, dim=-1) if rep > 1 else b

    def _interleave(self, coded: torch.Tensor) -> torch.Tensor:
        rows, cols = interleaver_shape(self.mode_bps, self.long_interleave)
        n = rows * cols
        coded = torch.nn.functional.pad(coded, (0, (-coded.shape[-1]) % n))
        perm = _index(interleave_permutation(rows, cols), coded.device)
        return coded.reshape(-1, n)[:, perm].reshape(-1)

    def frame_symbols(self, data) -> torch.Tensor:
        """(F, 256) scrambled 8PSK symbol indices, preamble included."""
        bps = self.bits_per_symbol
        inter = self._interleave(self._coded_bits(data_to_bits(data)))
        dev = inter.device
        n_sym = inter.shape[-1] // bps
        groups = inter[: n_sym * bps].reshape(n_sym, bps)
        shifts = torch.arange(bps - 1, -1, -1, dtype=SYMBOL_DTYPE, device=dev)
        vals = (groups << shifts).sum(dim=-1, dtype=SYMBOL_DTYPE)
        dsym = _index(_GRAY_TO_INDEX[bps], dev)[vals.long()].to(SYMBOL_DTYPE)

        frames = -(-n_sym // DATA_SYMS_PER_FRAME)
        dsym = torch.nn.functional.pad(dsym, (0, frames * DATA_SYMS_PER_FRAME - n_sym))
        data_pos, _ = _frame_layout()
        body = torch.zeros((frames, FRAME_SYMS - PREAMBLE_SYMS), dtype=SYMBOL_DTYPE, device=dev)
        body[:, _index(data_pos, dev)] = dsym.reshape(frames, DATA_SYMS_PER_FRAME)
        scr = torch.from_numpy(frame_scrambler().astype(np.int32)).to(dev)
        body = (body + scr[None, :]) % 8
        pre = torch.from_numpy(preamble_indices()).to(dev)
        return torch.cat([pre[None, :].expand(frames, PREAMBLE_SYMS), body], dim=1)

    def modulate(self, data) -> torch.Tensor:
        syms = self.frame_symbols(data).reshape(-1)
        base = _psk8(syms.device)[syms.long()].repeat_interleave(self.samples_per_symbol())
        carrier = _carrier(base.shape[-1], self.common.sample_rate, base.device)
        return (self.common.amplitude * base * carrier).to(IQ_DTYPE)

    # ------------------------------------------------------------- RX

    def _symbol_stream(self, samples: torch.Tensor) -> torch.Tensor:
        sps = self.samples_per_symbol()
        n = samples.shape[-1]
        base = samples * torch.conj(_carrier(n, self.common.sample_rate, samples.device))
        s = n // sps
        return torch.mean(base[: s * sps].reshape(s, sps), dim=-1)

    def _equalize_frames(self, frames_iq: torch.Tensor) -> torch.Tensor:
        """(F, 256) symbols -> (F, 128) equalised data symbols.

        Channel gain anchors: the preamble (one complex LS gain) and the
        three descrambled probe blocks, linearly interpolated over the
        frame, so slow fading and static offsets are tracked per frame.
        """
        dev = frames_iq.device
        pts = _psk8(dev)
        pre_pts = pts[_index(preamble_indices(), dev)]
        body = frames_iq[:, PREAMBLE_SYMS:]
        descr = body * torch.conj(pts[_index(frame_scrambler(), dev)])
        data_pos, probe_pos = _frame_layout()

        g_pre = torch.mean(frames_iq[:, :PREAMBLE_SYMS] * torch.conj(pre_pts), dim=1)
        probes = descr[:, _index(probe_pos, dev)].reshape(-1, 3, 16)
        g_probe = torch.mean(probes, dim=-1)  # (F, 3): probe tx symbol = 1+0j
        anchors_t = torch.tensor(
            [PREAMBLE_SYMS / 2.0]
            + [PREAMBLE_SYMS + float(probe_pos[16 * k] + 8) for k in range(3)],
            dtype=REAL_DTYPE, device=dev)
        anchors_g = torch.cat([g_pre[:, None], g_probe], dim=1)  # (F, 4)
        t_data = torch.from_numpy(PREAMBLE_SYMS + data_pos.astype(np.float32)).to(dev)
        gains = torch.complex(interp(t_data, anchors_t, anchors_g.real),
                              interp(t_data, anchors_t, anchors_g.imag))  # (F, 128)
        data = descr[:, _index(data_pos, dev)]
        denom = torch.clamp_min(torch.abs(gains), 1e-9)
        return data * torch.conj(gains) / (denom * denom)

    def demodulate(self, samples) -> DemodResult:
        """IQ -> bytes. A tensor is demodulated on its own device, anything
        else on the waveform's."""
        if not isinstance(samples, torch.Tensor):
            samples = torch.as_tensor(np.asarray(samples), device=self.device)
        stream = self._symbol_stream(samples.to(IQ_DTYPE))
        dev = stream.device
        f = stream.shape[-1] // FRAME_SYMS
        if f == 0:
            empty = torch.zeros(0, dtype=SYMBOL_DTYPE, device=dev)
            return DemodResult(bits=empty, symbols=empty)
        eq = self._equalize_frames(stream[: f * FRAME_SYMS].reshape(f, FRAME_SYMS)).reshape(-1)

        bps = self.bits_per_symbol
        pts = _psk8(dev)
        con = pts[_index(_GRAY_TO_INDEX[bps], dev)]  # constellation in value order
        llr = soft_demap_llr(eq, con)  # (S, bps), > 0 means bit 0
        soft = torch.tanh(llr / 2.0).reshape(-1)  # +1 ~ bit 0 (the decoder's convention)

        _, rep, coded = MODES[self.mode_bps]
        rows, cols = interleaver_shape(self.mode_bps, self.long_interleave)
        n = rows * cols
        spans = soft.shape[-1] // n
        inv = _index(np.argsort(interleave_permutation(rows, cols)), dev)
        deint = soft[: spans * n].reshape(spans, n)[:, inv].reshape(-1)
        if rep > 1:
            k = deint.shape[-1] // rep
            deint = torch.sum(deint[: k * rep].reshape(k, rep), dim=-1) / rep
        if coded:
            bits = viterbi_decode(deint, 7, CONV_POLYS, terminated=True, soft=True)
        else:
            bits = (deint < 0).to(SYMBOL_DTYPE)
        symbols = torch.argmax(-torch.abs(eq[:, None] - pts), dim=-1).to(SYMBOL_DTYPE)
        return DemodResult(bits=pack_demod_bits(bits), symbols=symbols)

    def get_modulation_stages(self, data):
        bits = data_to_bits(data)
        return [("input bits", bits),
                ("coded+repeated bits", self._coded_bits(bits)),
                ("framed scrambled symbols", self.frame_symbols(data)),
                ("modulated IQ", self.modulate(data))]


@register_waveform("STANAG-4285", aliases=("STANAG",))
def _stanag(sample_rate: float, device: torch.device) -> Stanag4285:
    return Stanag4285(common=CommonParams(sample_rate=max(sample_rate, 9600.0)), device=device)
