"""MIL-STD-188-110A serial-tone HF modem: conformant framing and autobaud.

PyTorch counterpart of ``r4w_tpu.waveforms.milstd188110``, with the same
frame:

* 2400 Bd on 1800 Hz; every rate rides scrambled 8PSK channel symbols.
* Sync preamble of 0.2 s segments of fifteen 32-symbol blocks. Each block
  is a cyclic rotation of a known 32-chip BPSK sequence carrying a 3-bit
  value: 9 fixed sync blocks [0,1,3,0,1,3,1,2,0], then D1 (interleave), D2
  (rate), a 3-block countdown of remaining segments and a zero pad block.
  D1/D2 let the receiver autobaud: detect rate and interleave unaided.
* Data alternates unknown (data) and known (probe) symbols: 32U/16K at
  2400 bps, 20U/20K at 150-1200 bps, no probes at 75 bps (Walsh blocks).
* Mappings: tribit Gray onto 8PSK (2400), dibit onto {0,2,6,4} (1200), bit
  onto {0,4} (150-600), and at 75 bps each 2 coded bits select one of four
  32-chip Walsh sequences on {0,4}.
* Scrambler: 12-bit LFSR x^12+x^6+x^4+x+1, 3 bits per symbol, period 160.
* FEC: K=7 rate-1/2 (0o171/0o133) plus repetition ×2/×4 at 300/150 bps,
  soft-decision Viterbi decode (`fec.convolutional`, the Hopper kernels on
  a CUDA tensor).
* Interleaver: helical block matrix (40 rows, 10 at 75 bps) loaded with a
  row increment of 9 and fetched row-major; span 0.6 s (short) or 4.8 s
  (long) of coded bits.

D1 ∈ {7: zero, 6: short, 4: long} interleave; D2 = rate index (75 → 0 ..
2400 → 5), the reference's documented local table.

The carrier phase is computed in float32, 2π·f/fs times a float32 sample
index, as the reference does; a float64 phase would move the soft values
away from its. The probe-gain interpolation is a searchsorted lerp with
``jnp.interp``'s formula and its clamping outside the anchors, and the
75 bps soft scaling takes the population standard deviation.
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
BLOCK = 32                      # preamble block length (symbols)
SEGMENT_BLOCKS = 15             # blocks per 0.2 s preamble segment
SEGMENT_SYMS = BLOCK * SEGMENT_BLOCKS  # 480 symbols = 0.2 s
SYNC_PATTERN = (0, 1, 3, 0, 1, 3, 1, 2, 0)
CONV_POLYS = (0o171, 0o133)
SCRAMBLE_PERIOD = 160

RATES = (75, 150, 300, 600, 1200, 2400)
D1_BY_INTERLEAVE = {"zero": 7, "short": 6, "long": 4}
INTERLEAVE_BY_D1 = {v: k for k, v in D1_BY_INTERLEAVE.items()}

# rate -> (bits per channel grouping, repetition, (unknown, known) pattern)
MODE_TABLE: dict[int, tuple[int, int, tuple[int, int]]] = {
    2400: (3, 1, (32, 16)),
    1200: (2, 1, (20, 20)),
    600: (1, 1, (20, 20)),
    300: (1, 2, (20, 20)),
    150: (1, 4, (20, 20)),
    75: (2, 1, (32, 0)),  # 2 coded bits -> one 32-chip Walsh block
}

_DIBIT_TO_INDEX = np.array([0, 2, 6, 4], np.int32)
_TRIBIT_TO_INDEX = np.array([0, 1, 3, 2, 7, 6, 4, 5], np.int32)
_BIT_TO_INDEX = np.array([0, 4], np.int32)
_INDEX_TABLES = {1: _BIT_TO_INDEX, 2: _DIBIT_TO_INDEX, 3: _TRIBIT_TO_INDEX}


@functools.lru_cache(maxsize=None)
def base_block() -> np.ndarray:
    """32-chip preamble base sequence as 8PSK indices {0,4}: degree-5
    m-sequence x^5+x^4+x^2+x+1 (mask 0b11011) tiled 31→32."""
    bits = lfsr_bits(5, 0b11011, 0x1F, length=31)
    return np.concatenate([bits, bits[:1]]).astype(np.int32) * 4


@functools.lru_cache(maxsize=None)
def scrambler_sequence() -> np.ndarray:
    """160-symbol periodic scrambler values 0..7 (x^12+x^6+x^4+x+1,
    init 0xBAD, 3 bits/symbol)."""
    bits = lfsr_bits(12, 0b100000101001, 0xBAD, length=3 * SCRAMBLE_PERIOD)
    tri = bits.astype(np.int32).reshape(-1, 3)
    return tri[:, 0] * 4 + tri[:, 1] * 2 + tri[:, 2]


@functools.lru_cache(maxsize=None)
def walsh_blocks() -> np.ndarray:
    """(4, 32) Walsh sequences as 8PSK indices {0,4}: Hadamard-4 rows,
    each chip repeated 8×."""
    h4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1],
                   [1, 1, -1, -1], [1, -1, -1, 1]])
    chips = np.repeat(h4, 8, axis=1)  # (4, 32) in ±1
    return ((1 - chips) * 2).astype(np.int32)  # +1 -> 0, -1 -> 4


def interleaver_shape(rate: int, interleave: str) -> tuple[int, int]:
    """(rows, cols): span = 0.6 s (short) / 4.8 s (long) of coded bits."""
    if interleave == "zero":
        return 1, 1
    bps_coded = {75: 150, 150: 600, 300: 1200, 600: 1200,
                 1200: 2400, 2400: 4800}[rate]
    span = 0.6 if interleave == "short" else 4.8
    bits = int(round(bps_coded * span))
    rows = 10 if rate == 75 else 40
    return rows, bits // rows


@functools.lru_cache(maxsize=None)
def interleave_permutation(rows: int, cols: int) -> np.ndarray:
    """out[j] = in[perm[j]]: load col-by-col with row increment 9
    (bit i -> row (9·i) mod rows, col i//rows), fetch row-major."""
    rinv = pow(9, -1, rows)
    j = np.arange(rows * cols)
    row, col = j // cols, j % cols
    perm = rows * col + (rinv * row) % rows
    return perm.astype(np.int32)


def segment_values(d1: int, d2: int, remaining: int) -> np.ndarray:
    """The 15 block values of one preamble segment."""
    count = [(remaining >> 6) & 7, (remaining >> 3) & 7, remaining & 7]
    return np.asarray(list(SYNC_PATTERN) + [d1, d2] + count + [0], np.int32)


def _carrier(n: int, sample_rate: float, device: torch.device) -> torch.Tensor:
    """exp(j·φ[i]), φ[i] = float32(2π·f/fs) · i in float32."""
    step = torch.tensor(2.0 * math.pi * CARRIER_HZ / sample_rate, dtype=REAL_DTYPE)
    ph = step.to(device) * torch.arange(n, dtype=REAL_DTYPE, device=device)
    return torch.complex(torch.cos(ph), torch.sin(ph))


@dataclasses.dataclass(frozen=True)
class MilStd188110(Waveform):
    """MIL-STD-188-110A modem; `demodulate` autobauds from D1/D2 by default."""

    common: CommonParams = CommonParams(sample_rate=9600.0)
    rate: int = 1200
    interleave: str = "short"  # zero | short | long
    device: torch.device = DEFAULT_DEVICE

    name = "MIL-STD-188-110"

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return max(int(round(self.common.sample_rate / SYMBOL_RATE)), 1)

    @property
    def bits_per_symbol(self) -> int:
        return MODE_TABLE[self.rate][0]

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name=self.name,
            full_name="MIL-STD-188-110 serial-tone HF modem",
            description="2400 Bd scrambled 8PSK with CCSK autobaud "
                        "preamble, known probes, helical interleaver",
            complexity=4,
            bits_per_symbol=self.bits_per_symbol,
            characteristics=(
                f"{self.rate} bps, {self.interleave} interleave",
                "K=7 rate-1/2 FEC + repetition",
                "Autobaud D1/D2 preamble",
                "75 bps orthogonal Walsh mode",
            ),
        )

    # ------------------------------------------------------------- TX

    def _n_segments(self) -> int:
        return {"zero": 1, "short": 3, "long": 24}[self.interleave]

    def preamble_symbols(self) -> np.ndarray:
        """All preamble segments as one (N·480,) index vector."""
        d1 = D1_BY_INTERLEAVE[self.interleave]
        d2 = RATES.index(self.rate)
        base = base_block()
        n = self._n_segments()
        segs = [np.concatenate([np.roll(base, -4 * int(v))
                                for v in segment_values(d1, d2, n - 1 - s)])
                for s in range(n)]
        return np.concatenate(segs)

    def _coded_bits(self, bits: np.ndarray) -> torch.Tensor:
        _, rep, _ = MODE_TABLE[self.rate]
        b = conv_encode(torch.from_numpy(np.asarray(bits, np.int32)).to(self.device), 7,
                        CONV_POLYS, terminate=True)
        return b.repeat_interleave(rep, dim=-1) if rep > 1 else b

    def _interleave_bits(self, coded: torch.Tensor) -> torch.Tensor:
        rows, cols = interleaver_shape(self.rate, self.interleave)
        n = rows * cols
        if n <= 1:
            return coded
        coded = torch.nn.functional.pad(coded, (0, (-coded.shape[-1]) % n))
        perm = _index(interleave_permutation(rows, cols), coded.device)
        return coded.reshape(-1, n)[:, perm].reshape(-1)

    def data_symbols(self, data) -> torch.Tensor:
        """Unknown-channel symbol indices (pre-scramble, no probes)."""
        inter = self._interleave_bits(self._coded_bits(data_to_bits(data)))
        if self.rate == 75:
            pairs = inter[: (inter.shape[-1] // 2) * 2].reshape(-1, 2).long()
            walsh = _index(walsh_blocks(), inter.device)[pairs[:, 0] * 2 + pairs[:, 1]]
            return walsh.reshape(-1).to(SYMBOL_DTYPE)
        bps = self.bits_per_symbol
        n_sym = inter.shape[-1] // bps
        groups = inter[: n_sym * bps].reshape(n_sym, bps)
        shifts = torch.arange(bps - 1, -1, -1, dtype=SYMBOL_DTYPE, device=inter.device)
        vals = (groups << shifts).sum(dim=-1, dtype=SYMBOL_DTYPE)
        return _index(_INDEX_TABLES[bps], inter.device)[vals.long()].to(SYMBOL_DTYPE)

    def frame_symbols(self, data) -> torch.Tensor:
        """Full scrambled on-air symbol index stream (preamble + data)."""
        dsym = self.data_symbols(data)
        u, k = MODE_TABLE[self.rate][2]
        n_frames = -(-dsym.shape[-1] // u)
        dsym = torch.nn.functional.pad(dsym, (0, n_frames * u - dsym.shape[-1]))
        dsym = dsym.reshape(n_frames, u)
        if k:
            probes = torch.zeros((n_frames, k), dtype=SYMBOL_DTYPE, device=dsym.device)
            body = torch.cat([dsym, probes], dim=1).reshape(-1)
        else:
            body = dsym.reshape(-1)
        n = body.shape[-1]
        scr = np.tile(scrambler_sequence(), -(-n // SCRAMBLE_PERIOD))[:n]
        body = (body + torch.from_numpy(scr.astype(np.int32)).to(body.device)) % 8
        pre = torch.from_numpy(self.preamble_symbols()).to(body.device)
        return torch.cat([pre, body])

    def modulate(self, data) -> torch.Tensor:
        syms = self.frame_symbols(data)
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

    @staticmethod
    def detect_preamble(stream: torch.Tensor) -> tuple[int, str, int]:
        """Autobaud: decode the block values of the first segment.

        Returns (rate, interleave, preamble_syms). Raises ValueError if
        the stream is shorter than one segment or the sync pattern does
        not match. Reads the block values on the host.
        """
        if stream.shape[-1] < SEGMENT_SYMS:
            raise ValueError(f"MIL-STD-188-110 needs {SEGMENT_SYMS} symbols to find "
                             f"the preamble, got {stream.shape[-1]}")
        base = _psk8(stream.device)[_index(base_block(), stream.device)]  # (32,)
        rot = torch.stack([torch.roll(base, -4 * v) for v in range(8)])  # (8, 32)
        blocks = stream[:SEGMENT_SYMS].reshape(SEGMENT_BLOCKS, BLOCK)
        corr = torch.abs(torch.einsum("bn,vn->bv", blocks, torch.conj(rot)))
        vals = torch.argmax(corr, dim=-1).cpu().numpy()
        if tuple(vals[: len(SYNC_PATTERN)]) != SYNC_PATTERN:
            raise ValueError("MIL-STD-188-110 sync pattern not found")
        d1, d2 = int(vals[9]), int(vals[10])
        remaining = (int(vals[11]) << 6) | (int(vals[12]) << 3) | int(vals[13])
        interleave = INTERLEAVE_BY_D1.get(d1)
        if interleave is None or d2 >= len(RATES):
            raise ValueError(f"invalid D1/D2: {d1}/{d2}")
        return RATES[d2], interleave, (remaining + 1) * SEGMENT_SYMS

    def demodulate(self, samples, autobaud: bool = True) -> DemodResult:
        """IQ -> bytes. A tensor is demodulated on its own device, anything
        else on the waveform's."""
        if not isinstance(samples, torch.Tensor):
            samples = torch.as_tensor(np.asarray(samples), device=self.device)
        stream = self._symbol_stream(samples.to(IQ_DTYPE))
        modem = self
        if autobaud:
            rate, interleave, pre_syms = self.detect_preamble(stream)
            if (rate, interleave) != (self.rate, self.interleave):
                modem = dataclasses.replace(self, rate=rate, interleave=interleave)
        else:
            pre_syms = modem._n_segments() * SEGMENT_SYMS
        return modem._demodulate_body(stream, pre_syms)

    def _demodulate_body(self, stream: torch.Tensor, pre_syms: int) -> DemodResult:
        device = stream.device
        pts = _psk8(device)
        body = stream[pre_syms:]
        n = body.shape[-1]
        scr = np.tile(scrambler_sequence(), -(-n // SCRAMBLE_PERIOD))[:n]
        descr = body * torch.conj(pts[_index(scr, device)])

        u, k = MODE_TABLE[self.rate][2]
        frame = u + k
        n_frames = n // frame
        if n_frames == 0:
            empty = torch.zeros(0, dtype=SYMBOL_DTYPE, device=device)
            return DemodResult(bits=empty, symbols=empty)
        descr = descr[: n_frames * frame].reshape(n_frames, frame)

        # channel gain from the last preamble block, a known sequence
        pre_pts = pts[_index(self.preamble_symbols()[-BLOCK:], device)]
        g0 = torch.mean(stream[pre_syms - BLOCK:pre_syms] * torch.conj(pre_pts))
        if k:
            # probe blocks transmit index 0 -> descrambled probe == gain;
            # the preamble's tail anchors the first frame
            g = torch.mean(descr[:, u:], dim=1)  # (F,)
            frames = torch.arange(n_frames, dtype=REAL_DTYPE, device=device)
            anchors_t = torch.cat([torch.tensor([-BLOCK / 2.0], dtype=REAL_DTYPE, device=device),
                                   frames * frame + u + k / 2.0])
            anchors_g = torch.cat([g0[None], g])
            t_data = (frames[:, None] * frame
                      + torch.arange(u, dtype=REAL_DTYPE, device=device)[None, :]).reshape(-1)
            gains = torch.complex(interp(t_data, anchors_t, anchors_g.real),
                                  interp(t_data, anchors_t, anchors_g.imag))
            denom = torch.clamp_min(torch.abs(gains), 1e-9)
            eq = descr[:, :u].reshape(-1) * torch.conj(gains) / (denom * denom)
        else:
            denom = torch.clamp_min(torch.abs(g0), 1e-9)
            eq = descr.reshape(-1) * torch.conj(g0) / (denom * denom)

        if self.rate == 75:
            nblk = eq.shape[-1] // BLOCK
            blocks = eq[: nblk * BLOCK].reshape(nblk, BLOCK)
            wpts = pts[_index(walsh_blocks(), device)]  # (4, 32)
            corr = torch.einsum("bn,wn->bw", blocks, torch.conj(wpts)).real
            # soft bits from Walsh correlations (max over matching half)
            b0 = torch.amax(corr[:, :2], dim=1) - torch.amax(corr[:, 2:], dim=1)  # bit0: w<2 -> 0
            b1 = (torch.maximum(corr[:, 0], corr[:, 2])
                  - torch.maximum(corr[:, 1], corr[:, 3]))
            soft = torch.stack([b0, b1], dim=1).reshape(-1)
            soft = torch.tanh(soft / torch.clamp_min(torch.std(soft, correction=0), 1e-9))
            symbols = torch.argmax(corr, dim=-1).to(SYMBOL_DTYPE)
        else:
            con = pts[_index(_INDEX_TABLES[self.bits_per_symbol], device)]
            soft = torch.tanh(soft_demap_llr(eq, con) / 2.0).reshape(-1)
            symbols = torch.argmax(-torch.abs(eq[:, None] - pts[None, :]), dim=-1).to(SYMBOL_DTYPE)

        rows, cols = interleaver_shape(self.rate, self.interleave)
        nspan = rows * cols
        if nspan > 1:
            spans = soft.shape[-1] // nspan
            inv = _index(np.argsort(interleave_permutation(rows, cols)), device)
            soft = soft[: spans * nspan].reshape(spans, nspan)[:, inv].reshape(-1)
        _, rep, _ = MODE_TABLE[self.rate]
        if rep > 1:
            m = soft.shape[-1] // rep
            soft = torch.sum(soft[: m * rep].reshape(m, rep), dim=-1) / rep
        bits = viterbi_decode(soft, 7, CONV_POLYS, terminated=True, soft=True)
        return DemodResult(
            bits=pack_demod_bits(bits), symbols=symbols,
            metadata={"rate": self.rate, "interleave": self.interleave})

    def get_modulation_stages(self, data):
        bits = data_to_bits(data)
        return [("input bits", bits),
                ("coded bits", self._coded_bits(bits)),
                ("channel symbols", self.frame_symbols(data)),
                ("modulated IQ", self.modulate(data))]


@register_waveform("MIL-STD-188-110", aliases=("188110", "MIL188110"))
def _milstd(sample_rate: float, device: torch.device) -> MilStd188110:
    return MilStd188110(common=CommonParams(sample_rate=max(sample_rate, 9600.0)),
                        device=device)
