"""ADS-B Mode-S extended squitter encode/decode.

PyTorch counterpart of ``r4w_tpu.adsb`` (waveform/adsb.rs re-design).
DF17 112-bit frames: DF(5) | CA(3) | ICAO(24) | ME(56) | PI(24 = CRC).
CRC-24 uses the Mode-S polynomial 0xFFF409 (the port's `fec.crc`, on the
host's CPU). Supports identification (TC 1-4 callsign) and
airborne-position (TC 9-18 altitude) messages; the frames are host numpy,
the reference's code as it is, and pair with the port's ADS-B PPM
waveform (`waveforms/ppm.py`) for RF loopback on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.types import resolve_device
from r4w_tpu_torch.fec.crc import crc_compute
from r4w_tpu_torch.waveforms import create_waveform

_CHARSET = "#ABCDEFGHIJKLMNOPQRSTUVWXYZ##### ###############0123456789######"


def _bits_from_int(v: int, n: int) -> list[int]:
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


def _int_from_bits(bits) -> int:
    out = 0
    for b in bits:
        out = (out << 1) | int(b)
    return out


def crc24(bits112_or_88) -> int:
    """Mode-S CRC-24 over the first 88 bits (bytes padded MSB-first)."""
    bits = list(bits112_or_88)[:88]
    data = np.asarray(
        [_int_from_bits(bits[i : i + 8]) for i in range(0, 88, 8)], np.int32
    )
    return int(crc_compute(data, "crc24-adsb", device="cpu"))


@dataclasses.dataclass
class AdsbMessage:
    icao: int
    type_code: int
    capability: int = 5
    callsign: str | None = None
    altitude_ft: int | None = None
    crc_ok: bool = True

    # -- encode ------------------------------------------------------------
    def to_bits(self) -> np.ndarray:
        me = [0] * 56
        me[:5] = _bits_from_int(self.type_code, 5)
        if self.callsign is not None and 1 <= self.type_code <= 4:
            me[5:8] = _bits_from_int(0, 3)  # emitter category
            cs = (self.callsign.upper() + " " * 8)[:8]
            for i, ch in enumerate(cs):
                code = _CHARSET.find(ch)
                if code < 0:
                    code = 32  # space
                me[8 + 6 * i : 14 + 6 * i] = _bits_from_int(code, 6)
        elif self.altitude_ft is not None and 9 <= self.type_code <= 18:
            # 12-bit altitude field with Q=1 (25 ft increments)
            n = (self.altitude_ft + 1000) // 25
            alt11 = _bits_from_int(n, 11)
            me[8:20] = alt11[:7] + [1] + alt11[7:]
        frame = (
            _bits_from_int(17, 5)
            + _bits_from_int(self.capability, 3)
            + _bits_from_int(self.icao, 24)
            + me
        )
        pi = crc24(frame)
        return np.asarray(frame + _bits_from_int(pi, 24), np.int32)

    # -- decode ------------------------------------------------------------
    @classmethod
    def from_bits(cls, bits) -> "AdsbMessage | None":
        bits = list(np.asarray(bits).astype(int))
        if len(bits) < 112:
            return None
        bits = bits[:112]
        df = _int_from_bits(bits[:5])
        if df != 17:
            return None
        crc_ok = crc24(bits) == _int_from_bits(bits[88:112])
        icao = _int_from_bits(bits[8:32])
        me = bits[32:88]
        tc = _int_from_bits(me[:5])
        msg = cls(icao=icao, type_code=tc,
                  capability=_int_from_bits(bits[5:8]), crc_ok=crc_ok)
        if 1 <= tc <= 4:
            chars = []
            for i in range(8):
                code = _int_from_bits(me[8 + 6 * i : 14 + 6 * i])
                chars.append(_CHARSET[code] if code < len(_CHARSET) else "#")
            msg.callsign = "".join(chars).replace("#", "").strip()
        elif 9 <= tc <= 18:
            alt_field = me[8:20]
            q = alt_field[7]
            if q:
                n = _int_from_bits(alt_field[:7] + alt_field[8:])
                msg.altitude_ft = n * 25 - 1000
        return msg


def encode_identification(icao: int, callsign: str,
                          capability: int = 5) -> np.ndarray:
    """DF17 TC4 identification frame bits (112,)."""
    return AdsbMessage(icao=icao, type_code=4, capability=capability,
                       callsign=callsign).to_bits()


def encode_altitude(icao: int, altitude_ft: int) -> np.ndarray:
    """DF17 TC11 airborne-position frame (altitude only; CPR lat/lon 0)."""
    return AdsbMessage(icao=icao, type_code=11,
                       altitude_ft=altitude_ft).to_bits()


def decode_frame_bytes(data: bytes) -> "AdsbMessage | None":
    """Decode a 14-byte DF17 frame."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    return AdsbMessage.from_bits(bits)


def transmit_over_ppm(message: AdsbMessage, sample_rate: float = 8e6, device=None):
    """Modulate a frame with the ADS-B PPM waveform on `device`."""
    wf = create_waveform("ADS-B", sample_rate, resolve_device(device))
    bits = message.to_bits()
    return wf.modulate(bits.astype(np.int32))


def receive_over_ppm(samples, sample_rate: float = 8e6, device=None
                     ) -> "AdsbMessage | None":
    """Demodulate with the ADS-B PPM waveform (on the samples' device when
    they are a tensor) and parse the frame on the host."""
    if isinstance(samples, torch.Tensor) and device is None:
        device = samples.device
    wf = create_waveform("ADS-B", sample_rate, resolve_device(device))
    res = wf.demodulate(samples)
    return AdsbMessage.from_bits(res.symbols.cpu().numpy())
