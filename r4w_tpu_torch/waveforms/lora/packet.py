"""LoRa packet framing: explicit header + payload CRC.

Counterpart of ``r4w_tpu.waveforms.lora.packet``, a numpy copy on the
port's CRC (`fec.crc`). Explicit header (same rate as the payload):
[len u8][flags u8: crc_enabled|cr][header checksum u8], then the payload,
then CRC-16 (polynomial 0x1021, init 0x0000, the LoRa payload CRC) when
enabled. The CRC runs on `resolve_device(device)`; the bytes stay numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from r4w_tpu_torch.fec.crc import crc_compute


@dataclasses.dataclass(frozen=True)
class PacketHeader:
    payload_len: int
    cr: int = 1
    crc_enabled: bool = True

    def encode(self) -> np.ndarray:
        flags = ((1 if self.crc_enabled else 0) << 3) | (self.cr & 0x7)
        chk = (self.payload_len ^ flags ^ 0x55) & 0xFF
        return np.array([self.payload_len & 0xFF, flags, chk], np.int32)

    @classmethod
    def decode(cls, data: np.ndarray) -> "PacketHeader | None":
        if len(data) < 3:
            return None
        ln, flags, chk = int(data[0]), int(data[1]), int(data[2])
        if chk != (ln ^ flags ^ 0x55) & 0xFF:
            return None
        return cls(payload_len=ln, cr=flags & 0x7,
                   crc_enabled=bool(flags & 0x8))


def build_packet(payload: bytes, cr: int = 1, crc_enabled: bool = True,
                 device=None) -> np.ndarray:
    """header + payload [+ crc16] as byte array for the modulator."""
    hdr = PacketHeader(len(payload), cr, crc_enabled)
    body = np.frombuffer(payload, np.uint8).astype(np.int32)
    parts = [hdr.encode(), body]
    if crc_enabled:
        crc = int(crc_compute(body, "crc16-lora", device))
        parts.append(np.array([(crc >> 8) & 0xFF, crc & 0xFF], np.int32))
    return np.concatenate(parts)


def parse_packet(data: np.ndarray, device=None):
    """bytes -> (payload bytes, crc_ok | None). None header -> (b'', None)."""
    hdr = PacketHeader.decode(np.asarray(data))
    if hdr is None:
        return b"", None
    start = 3
    payload = np.asarray(data[start : start + hdr.payload_len], np.int64)
    crc_ok = None
    if hdr.crc_enabled:
        crc_bytes = data[start + hdr.payload_len : start + hdr.payload_len + 2]
        if len(crc_bytes) == 2:
            want = (int(crc_bytes[0]) << 8) | int(crc_bytes[1])
            got = int(crc_compute(payload.astype(np.int32), "crc16-lora", device))
            crc_ok = want == got
        else:
            crc_ok = False
    return bytes(payload.astype(np.uint8)), crc_ok
