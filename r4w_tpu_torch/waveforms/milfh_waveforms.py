"""Military frequency-hopping framework waveforms: SINCGARS and HAVEQUICK,
and SINCGARS data framing.

PyTorch counterpart of ``r4w_tpu.waveforms.milfh_waveforms``. The
classified pieces (TRANSEC keystream, operational hop algorithms, crypto)
sit behind a provider protocol whose only implementation is a seeded
simulator (`np.random.default_rng`, non-operational); the unclassified
PHY is the FHSS (hops × dwell) grid.

The data framer's wire format: preamble AA AA 7E, a 4-bit frame type and
12-bit sequence, a payload length byte, the payload and a CRC-16/CCITT
with init and final XOR 0xFFFF, the whole frame coded by the K=7 rate-1/2
convolutional code. `sincgars_deframe` decodes every candidate frame of
a capture in one batched hard-decision `viterbi_decode` (lanes = frames:
both Hopper Viterbi kernels launch once on a CUDA capture), then deframes
each lane as `SincgarsDataFramer.bits_to_frame` does.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np
import torch

from r4w_tpu_torch.core.types import SYMBOL_DTYPE, CommonParams, resolve_device
from r4w_tpu_torch.fec.convolutional import conv_encode, viterbi_decode
from r4w_tpu_torch.fec.crc import crc_compute
from r4w_tpu_torch.ops.coding import bytes_to_bits
from r4w_tpu_torch.waveforms.base import WaveformInfo, register_waveform
from r4w_tpu_torch.waveforms.fhss import FHSS

CONV_POLYS = (0o171, 0o133)


class HopSequenceProvider(Protocol):
    """Seam for the classified hop algorithm."""

    def hop_channels(self, n_hops: int) -> np.ndarray: ...


@dataclasses.dataclass(frozen=True)
class SimulatorHopProvider:
    """NON-OPERATIONAL training-mode hop pattern: a seeded PRNG."""

    num_channels: int
    seed: int = 0x51C

    def hop_channels(self, n_hops: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.num_channels, n_hops)


class _FhFramework(FHSS):
    """Shared framework: the FHSS PHY with a pluggable hop provider."""

    provider_seed: int = 0x51C

    def _channels_for(self, n_hops: int) -> np.ndarray:
        return SimulatorHopProvider(self.num_channels, self.provider_seed).hop_channels(n_hops)


@dataclasses.dataclass(frozen=True)
class Sincgars(_FhFramework):
    """SINCGARS VHF FH: 2320 channels 30-88 MHz at 25 kHz spacing, ~100
    hops/s, CPFSK data. Simulator TRANSEC only."""

    common: CommonParams = CommonParams(sample_rate=500_000.0)
    num_channels: int = 64  # baseband window of the 2320-channel set
    channel_spacing: float = 25_000.0 / 4  # scaled into the sample band
    hop_rate: float = 100.0
    symbols_per_hop: int = 160
    symbol_rate: float = 16_000.0
    deviation: float = 6500.0
    provider_seed: int = 0x51C

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="SINCGARS",
            full_name="Single Channel Ground and Airborne Radio System",
            description="VHF FH framework — simulator TRANSEC only",
            complexity=5, bits_per_symbol=1,
            characteristics=("Trait-split: hop algorithm pluggable",
                             "~100 hops/s CPFSK",
                             "TRAINING pattern, not operational"),
        )


@dataclasses.dataclass(frozen=True)
class Havequick(_FhFramework):
    """HAVEQUICK UHF FH: 7000 channels 225-400 MHz; WOD/TOD seeded dwells.
    Simulator pattern only."""

    common: CommonParams = CommonParams(sample_rate=500_000.0)
    num_channels: int = 64
    channel_spacing: float = 25_000.0 / 4
    hop_rate: float = 200.0
    symbols_per_hop: int = 40
    symbol_rate: float = 16_000.0
    deviation: float = 6500.0
    provider_seed: int = 0x440

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="HAVEQUICK", full_name="HAVEQUICK II UHF AM/FH radio",
            description="UHF FH framework — simulator WOD/TOD only",
            complexity=5, bits_per_symbol=1,
            characteristics=("Word-of-day seeded dwell pattern (stub)",),
        )


@register_waveform("SINCGARS")
def _sincgars(sample_rate: float, device: torch.device) -> Sincgars:
    return Sincgars(common=CommonParams(sample_rate=max(sample_rate, 5e5)), device=device)


@register_waveform("HAVEQUICK", aliases=("HQ",))
def _havequick(sample_rate: float, device: torch.device) -> Havequick:
    return Havequick(common=CommonParams(sample_rate=max(sample_rate, 5e5)), device=device)


# --------------------------------------------- SINCGARS data framing

SINCGARS_DATA_MODES: dict[int, int] = {
    # bps -> frame size in bits
    75: 75, 150: 150, 300: 300, 600: 600, 1200: 1200, 2400: 2400,
    4800: 480, 16000: 1600,
}

SINCGARS_FRAME_PREAMBLE = (0xAA, 0xAA, 0x7E)

FRAME_TYPES = {"data": 0, "ack": 1, "nak": 2, "sync": 3, "eot": 4}
FRAME_TYPE_NAMES = {v: k for k, v in FRAME_TYPES.items()}


@dataclasses.dataclass
class SincgarsDataFrame:
    """One data-mode frame."""

    sequence: int
    payload: bytes
    frame_type: str = "data"


def _sincgars_crc(payload: bytes) -> int:
    """CRC-16/CCITT, init 0xFFFF, final XOR 0xFFFF, on the host."""
    if not payload:
        return 0xFFFF  # crc of the empty message: init ^ xorout
    arr = np.frombuffer(payload, np.uint8).astype(np.int32)
    return int(crc_compute(torch.from_numpy(arr), "crc16-ccitt")) ^ 0xFFFF


class SincgarsDataFramer:
    """Framer for the SINCGARS data modes."""

    OVERHEAD_BYTES = 8  # preamble 3 + header 2 + len 1 + crc 2

    def __init__(self, mode_bps: int = 1200, use_fec: bool = True):
        if mode_bps not in SINCGARS_DATA_MODES:
            raise ValueError(f"unknown SINCGARS data mode {mode_bps}")
        self.mode_bps = mode_bps
        self.use_fec = use_fec
        self.sequence = 0

    @property
    def frame_size_bits(self) -> int:
        return SINCGARS_DATA_MODES[self.mode_bps]

    def max_payload_size(self) -> int:
        payload_bits = max(self.frame_size_bits - 8 * self.OVERHEAD_BYTES, 8)
        return payload_bits // (16 if self.use_fec else 8)

    def frame_data(self, data: bytes) -> list[SincgarsDataFrame]:
        size = self.max_payload_size()
        frames = []
        for i in range(0, max(len(data), 1), size):
            frames.append(SincgarsDataFrame(sequence=self.sequence,
                                            payload=bytes(data[i:i + size])))
            self.sequence = (self.sequence + 1) & 0xFFFF
        return frames

    def frame_to_bits(self, frame: SincgarsDataFrame) -> np.ndarray:
        header = ((FRAME_TYPES[frame.frame_type] & 0xF) << 12) | (frame.sequence & 0x0FFF)
        wire = bytes(SINCGARS_FRAME_PREAMBLE) + bytes([
            header >> 8, header & 0xFF, len(frame.payload) & 0xFF,
        ]) + frame.payload
        crc = _sincgars_crc(frame.payload)
        wire += bytes([crc >> 8, crc & 0xFF])
        bits = np.unpackbits(np.frombuffer(wire, np.uint8)).astype(np.int32)
        if self.use_fec:
            # the encoder runs on the host
            bits = conv_encode(torch.from_numpy(bits), 7, CONV_POLYS, terminate=True).numpy()
        return bits

    def deframe(self, bits: np.ndarray) -> SincgarsDataFrame:
        """Decoded frame bits -> the frame; raises ValueError on a short
        frame, a bad preamble or frame type, or a CRC mismatch."""
        data = np.packbits(np.asarray(bits).astype(np.uint8)).tobytes()
        if len(data) < self.OVERHEAD_BYTES:
            raise ValueError("frame too short")
        if data[:3] != bytes(SINCGARS_FRAME_PREAMBLE):
            raise ValueError("invalid frame preamble")
        header = (data[3] << 8) | data[4]
        ftype = (header >> 12) & 0xF
        if ftype not in FRAME_TYPE_NAMES:
            raise ValueError(f"invalid frame type {ftype}")
        n = data[5]
        if len(data) < 8 + n:
            raise ValueError("frame too short for payload")
        payload = data[6:6 + n]
        rx_crc = (data[6 + n] << 8) | data[7 + n]
        if rx_crc != _sincgars_crc(payload):
            raise ValueError("CRC mismatch")
        return SincgarsDataFrame(sequence=header & 0x0FFF, payload=payload,
                                 frame_type=FRAME_TYPE_NAMES[ftype])

    def bits_to_frame(self, bits, device=None) -> SincgarsDataFrame:
        """One frame's on-air bits -> the frame. With FEC the hard-bit
        Viterbi decode runs on a tensor's own device, else on
        `resolve_device(device)`."""
        if self.use_fec:
            if not isinstance(bits, torch.Tensor):
                bits = torch.as_tensor(np.asarray(bits, np.int32), device=resolve_device(device))
            bits = viterbi_decode(bits, 7, CONV_POLYS, terminated=True).cpu().numpy()
        return self.deframe(np.asarray(bits, np.int32))


def sincgars_modulate_data(radio: Sincgars, data: bytes,
                           mode_bps: int = 1200) -> tuple[torch.Tensor, int]:
    """Frame `data` and modulate it through the SINCGARS FH PHY on the
    radio's device. Returns (iq, frame_bits), frame_bits the on-air length
    of each frame."""
    framer = SincgarsDataFramer(mode_bps)
    all_bits = [framer.frame_to_bits(f) for f in framer.frame_data(data)]
    flen = max(len(b) for b in all_bits)
    padded = np.concatenate([np.pad(b, (0, flen - len(b))) for b in all_bits])
    return radio.modulate(padded.astype(np.int32)), flen


def sincgars_deframe(bits: torch.Tensor, frame_bits: int,
                     mode_bps: int = 1200) -> list[SincgarsDataFrame]:
    """On-air bits (N,) -> the frames that pass their CRC.

    Every whole frame of the stream is a lane of one `viterbi_decode` on
    the bits' device; the lanes are deframed in order, and those that raise
    ValueError are skipped, as the reference's frame-by-frame loop skips
    them."""
    framer = SincgarsDataFramer(mode_bps)
    n_frames = bits.shape[-1] // frame_bits
    if n_frames == 0:
        return []
    lanes = bits[: n_frames * frame_bits].reshape(n_frames, frame_bits)
    if framer.use_fec:
        lanes = viterbi_decode(lanes, 7, CONV_POLYS, terminated=True)
    frames = []
    for lane in lanes.to(SYMBOL_DTYPE).cpu().numpy():
        try:
            frames.append(framer.deframe(lane))
        except ValueError:
            continue
    return frames


def sincgars_demodulate_data(radio: Sincgars, samples, frame_bits: int,
                             mode_bps: int = 1200) -> list[SincgarsDataFrame]:
    """Demodulate and deframe (`sincgars_deframe`) on the samples' device;
    returns the frames that pass their CRC."""
    return sincgars_deframe(bytes_to_bits(radio.demodulate(samples).bits), frame_bits, mode_bps)
