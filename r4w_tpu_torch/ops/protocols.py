"""Protocol codecs: AX.25/HDLC, APRS, SLIP, AIS, ACARS, CTCSS.

PyTorch counterpart of ``r4w_tpu.ops.protocols`` (ax25.rs, hdlc.rs,
aprs_decoder.rs, slip_decoder.rs, ais_encoder.rs, ais_decoder.rs,
acars_decoder.rs, ctcss_squelch.rs). The byte and bit framing is host
numpy, the reference's code as it is. CTCSS detection correlates the
audio with the 38-tone cosine and sine banks, two float32 products
(TF32 off), over any leading axes: a stack of windows is one call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, real_scalar, resolve_device, to_tensor

# ------------------------------------------------------- HDLC / AX.25

HDLC_FLAG = 0x7E


def crc16_x25(data: bytes) -> int:
    """CRC-16/X25 (reflected 0x1021, init 0xFFFF, xorout 0xFFFF) — the
    HDLC/AX.25 frame check sequence."""
    crc = 0xFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return crc ^ 0xFFFF


def hdlc_bit_stuff(bits: np.ndarray) -> np.ndarray:
    """Insert a 0 after five consecutive 1s (ax25.rs HDLC framing)."""
    out, run = [], 0
    for b in np.asarray(bits, np.int32):
        out.append(int(b))
        if b == 1:
            run += 1
            if run == 5:
                out.append(0)
                run = 0
        else:
            run = 0
    return np.asarray(out, np.int32)


def hdlc_bit_unstuff(bits: np.ndarray) -> np.ndarray:
    """Remove stuffed zeros (drop the 0 after five 1s)."""
    out, run = [], 0
    skip = False
    for b in np.asarray(bits, np.int32):
        if skip:
            skip = False
            run = 0
            continue
        out.append(int(b))
        if b == 1:
            run += 1
            if run == 5:
                skip = True
                run = 0
        else:
            run = 0
    return np.asarray(out, np.int32)


def nrzi_encode(bits: np.ndarray, initial: int = 1) -> np.ndarray:
    """NRZI: 0 toggles, 1 holds (HDLC convention)."""
    out = []
    level = initial
    for b in np.asarray(bits, np.int32):
        if b == 0:
            level ^= 1
        out.append(level)
    return np.asarray(out, np.int32)


def nrzi_decode(levels: np.ndarray, initial: int = 1) -> np.ndarray:
    lv = np.concatenate([[initial], np.asarray(levels, np.int32)])
    return (lv[1:] == lv[:-1]).astype(np.int32)


def _ax25_address(callsign: str, ssid: int, last: bool) -> bytes:
    """AX.25 address field: callsign shifted left 1, SSID byte."""
    cs = callsign.upper().ljust(6)[:6]
    out = bytes((ord(c) << 1) & 0xFF for c in cs)
    ssid_byte = 0x60 | ((ssid & 0xF) << 1) | (1 if last else 0)
    return out + bytes([ssid_byte])


def _ax25_parse_address(raw: bytes) -> tuple[str, int, bool]:
    cs = "".join(chr(b >> 1) for b in raw[:6]).strip()
    ssid = (raw[6] >> 1) & 0xF
    return cs, ssid, bool(raw[6] & 1)


@dataclasses.dataclass
class Ax25Frame:
    """AX.25 UI frame (ax25.rs)."""

    dest: str
    source: str
    info: bytes
    dest_ssid: int = 0
    source_ssid: int = 0
    control: int = 0x03  # UI
    pid: int = 0xF0      # no layer 3


def ax25_encode(frame: Ax25Frame) -> np.ndarray:
    """Frame -> NRZI bit stream with flags, stuffing, and FCS."""
    body = (_ax25_address(frame.dest, frame.dest_ssid, False)
            + _ax25_address(frame.source, frame.source_ssid, True)
            + bytes([frame.control, frame.pid]) + frame.info)
    fcs = crc16_x25(body)
    body += bytes([fcs & 0xFF, fcs >> 8])  # FCS little-endian
    bits = np.unpackbits(np.frombuffer(body, np.uint8),
                         bitorder="little").astype(np.int32)  # LSB first
    stuffed = hdlc_bit_stuff(bits)
    flag = np.unpackbits(np.asarray([HDLC_FLAG], np.uint8),
                         bitorder="little").astype(np.int32)
    return nrzi_encode(np.concatenate([flag, stuffed, flag]))


def ax25_decode(levels: np.ndarray) -> Ax25Frame:
    """NRZI bit stream -> frame; raises ValueError on bad FCS/format."""
    bits = nrzi_decode(levels)
    flag = np.unpackbits(np.asarray([HDLC_FLAG], np.uint8),
                         bitorder="little").astype(np.int32)
    # find opening and closing flags
    n = len(bits)
    starts = [i for i in range(n - 8 + 1)
              if (bits[i:i + 8] == flag).all()]
    if len(starts) < 2:
        raise ValueError("HDLC flags not found")
    inner = bits[starts[0] + 8:starts[-1]]
    raw = hdlc_bit_unstuff(inner)
    raw = raw[: (len(raw) // 8) * 8]
    body = np.packbits(raw.astype(np.uint8), bitorder="little").tobytes()
    if len(body) < 18:
        raise ValueError("frame too short")
    fcs_rx = body[-2] | (body[-1] << 8)
    payload = body[:-2]
    if crc16_x25(payload) != fcs_rx:
        raise ValueError("AX.25 FCS mismatch")
    dest, dssid, _ = _ax25_parse_address(payload[0:7])
    src, sssid, _ = _ax25_parse_address(payload[7:14])
    return Ax25Frame(dest=dest, source=src, info=payload[16:],
                     dest_ssid=dssid, source_ssid=sssid,
                     control=payload[14], pid=payload[15])


# --------------------------------------------------------------- APRS


def aprs_encode(source: str, payload: str, dest: str = "APRS",
                source_ssid: int = 0) -> np.ndarray:
    """APRS = AX.25 UI frame with a text payload (aprs_decoder.rs)."""
    return ax25_encode(Ax25Frame(dest=dest, source=source,
                                 info=payload.encode(),
                                 source_ssid=source_ssid))


def aprs_decode(levels: np.ndarray) -> dict:
    """-> {source, dest, message, type} (position/status/message...)."""
    fr = ax25_decode(levels)
    text = fr.info.decode(errors="replace")
    kind = {"!": "position", "=": "position", "@": "position-ts",
            ">": "status", ":": "message", "T": "telemetry"}.get(
        text[:1], "other")
    return {"source": fr.source, "dest": fr.dest, "message": text,
            "type": kind}


# --------------------------------------------------------------- SLIP

SLIP_END, SLIP_ESC, SLIP_ESC_END, SLIP_ESC_ESC = 0xC0, 0xDB, 0xDC, 0xDD


def slip_encode(data: bytes) -> bytes:
    """RFC 1055 framing (slip_decoder.rs counterpart)."""
    out = bytearray([SLIP_END])
    for b in data:
        if b == SLIP_END:
            out += bytes([SLIP_ESC, SLIP_ESC_END])
        elif b == SLIP_ESC:
            out += bytes([SLIP_ESC, SLIP_ESC_ESC])
        else:
            out.append(b)
    out.append(SLIP_END)
    return bytes(out)


def slip_decode(stream: bytes) -> list[bytes]:
    """-> list of decoded frames."""
    frames, cur, esc = [], bytearray(), False
    for b in stream:
        if esc:
            cur.append(SLIP_END if b == SLIP_ESC_END
                       else SLIP_ESC if b == SLIP_ESC_ESC else b)
            esc = False
        elif b == SLIP_ESC:
            esc = True
        elif b == SLIP_END:
            if cur:
                frames.append(bytes(cur))
                cur = bytearray()
        else:
            cur.append(b)
    return frames


# ---------------------------------------------------------------- AIS


def _ais_sixbit_encode(bits: np.ndarray) -> str:
    """Pack bits into the AIS 6-bit ASCII armor (ais_encoder.rs)."""
    bits = np.asarray(bits, np.int32)
    pad = (-len(bits)) % 6
    bits = np.concatenate([bits, np.zeros(pad, np.int32)])
    out = []
    for i in range(0, len(bits), 6):
        v = 0
        for b in bits[i:i + 6]:
            v = (v << 1) | int(b)
        v += 48
        if v > 87:
            v += 8
        out.append(chr(v))
    return "".join(out)


def _ais_sixbit_decode(payload: str) -> np.ndarray:
    bits = []
    for c in payload:
        v = ord(c) - 48
        if v > 40:
            v -= 8
        bits.extend((v >> (5 - i)) & 1 for i in range(6))
    return np.asarray(bits, np.int32)


def nmea_checksum(sentence: str) -> int:
    """XOR of chars between '!'/'$' and '*'."""
    c = 0
    for ch in sentence:
        c ^= ord(ch)
    return c


def ais_encode_position(mmsi: int, lat_deg: float, lon_deg: float,
                        sog_knots: float = 0.0, cog_deg: float = 0.0
                        ) -> str:
    """Build a !AIVDM sentence with a type-1 position report
    (ais_encoder.rs)."""
    def put(val: int, width: int, bits: list):
        bits.extend(((val >> (width - 1 - i)) & 1) for i in range(width))

    bits: list[int] = []
    put(1, 6, bits)                        # message type 1
    put(0, 2, bits)                        # repeat
    put(mmsi, 30, bits)
    put(0, 4, bits)                        # nav status
    put(0, 8, bits)                        # ROT
    put(int(round(sog_knots * 10)) & 0x3FF, 10, bits)
    put(1, 1, bits)                        # position accuracy
    put(int(round(lon_deg * 600_000)) & 0xFFFFFFF, 28, bits)
    put(int(round(lat_deg * 600_000)) & 0x7FFFFFF, 27, bits)
    put(int(round(cog_deg * 10)) & 0xFFF, 12, bits)
    put(511, 9, bits)                      # heading n/a
    put(60, 6, bits)                       # timestamp n/a
    put(0, 8, bits)                        # flags/spare
    put(0, 19, bits)                       # radio status
    payload = _ais_sixbit_encode(np.asarray(bits))
    body = f"AIVDM,1,1,,A,{payload},0"
    return f"!{body}*{nmea_checksum(body):02X}"


def ais_decode(sentence: str) -> dict:
    """Parse a !AIVDM sentence -> {mmsi, lat, lon, sog, cog, msg_type};
    raises ValueError on checksum failure (ais_decoder.rs)."""
    if not sentence.startswith("!") or "*" not in sentence:
        raise ValueError("not an NMEA sentence")
    body, cks = sentence[1:].rsplit("*", 1)
    if nmea_checksum(body) != int(cks, 16):
        raise ValueError("NMEA checksum mismatch")
    fields = body.split(",")
    bits = _ais_sixbit_decode(fields[5])

    def get(start: int, width: int, signed: bool = False) -> int:
        v = 0
        for b in bits[start:start + width]:
            v = (v << 1) | int(b)
        if signed and v >= 1 << (width - 1):
            v -= 1 << width
        return v

    msg_type = get(0, 6)
    return {
        "msg_type": msg_type,
        "mmsi": get(8, 30),
        "sog_knots": get(50, 10) / 10.0,
        "lon_deg": get(61, 28, signed=True) / 600_000.0,
        "lat_deg": get(89, 27, signed=True) / 600_000.0,
        "cog_deg": get(116, 12) / 10.0,
    }


# -------------------------------------------------------------- ACARS

ACARS_SOH, ACARS_STX, ACARS_ETX, ACARS_DEL = 0x01, 0x02, 0x03, 0x7F


def _acars_parity(byte: int) -> int:
    """Odd parity in bit 7 (ACARS character framing)."""
    b = byte & 0x7F
    ones = bin(b).count("1")
    return b | (0x80 if ones % 2 == 0 else 0)


def acars_encode(registration: str, label: str, text: str,
                 mode: str = "2") -> bytes:
    """ACARS block: SOH mode reg ACK label blk STX text ETX
    (acars_decoder.rs counterpart), odd character parity."""
    reg = registration.ljust(7)[:7]
    body = (chr(ACARS_SOH) + mode + reg + "\x15" + label.ljust(2)[:2]
            + "1" + chr(ACARS_STX) + text + chr(ACARS_ETX))
    return bytes(_acars_parity(ord(c)) for c in body)


def acars_decode(block: bytes) -> dict:
    """-> {registration, label, text}; raises on parity error."""
    chars = []
    for b in block:
        if _acars_parity(b & 0x7F) != b:
            raise ValueError(f"ACARS parity error on byte {b:#x}")
        chars.append(b & 0x7F)
    s = "".join(map(chr, chars))
    if not s or ord(s[0]) != ACARS_SOH:
        raise ValueError("missing SOH")
    stx = s.index(chr(ACARS_STX))
    etx = s.index(chr(ACARS_ETX))
    return {"mode": s[1], "registration": s[2:9].strip(),
            "label": s[10:12].strip(), "text": s[stx + 1:etx]}


# -------------------------------------------------------------- CTCSS

# the 38 standard EIA tones (ctcss_squelch.rs)
CTCSS_TONES = np.asarray([
    67.0, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5, 94.8, 97.4,
    100.0, 103.5, 107.2, 110.9, 114.8, 118.8, 123.0, 127.3, 131.8,
    136.5, 141.3, 146.2, 151.4, 156.7, 162.2, 167.9, 173.8, 179.9,
    186.2, 192.8, 199.5, 206.5, 213.8, 221.3, 229.1, 237.1, 245.3,
])


def _time(n: int, sample_rate: float, device) -> torch.Tensor:
    """float32 ``arange(n) / sample_rate`` (the quotient rounded once)."""
    return torch.arange(n, dtype=REAL_DTYPE, device=device) / real_scalar(sample_rate, device)


def ctcss_detect(audio, sample_rate: float, threshold: float = 8.0):
    """Detect the strongest CTCSS tone with the 38-tone correlation bank.

    Returns (tone_hz, metric) over audio's leading axes: metric = the
    strongest tone's power over the mean of the others; tone_hz = -1.0
    below `threshold`. The default sits above the white-noise max/mean
    statistic of a 38-tone bank (≈ ln 38 + γ ≈ 4.2), with margin: noise
    passes it in about 38·e^-8 ≈ 1.3% of windows.
    """
    x = to_tensor(audio, REAL_DTYPE)
    n = x.shape[-1]
    t = _time(n, sample_rate, x.device)
    tones = torch.from_numpy(CTCSS_TONES.astype(np.float32)).to(x.device)
    ph = 2.0 * np.pi * tones[:, None] * t[None, :]
    c = torch.matmul(x, torch.cos(ph).T)
    s = torch.matmul(x, torch.sin(ph).T)
    power = c * c + s * s
    best = torch.argmax(power, dim=-1)
    pbest = torch.amax(power, dim=-1)
    floor = (torch.sum(power, dim=-1) - pbest) / (power.shape[-1] - 1)
    metric = pbest / torch.clamp(floor, min=1e-12)
    tone = torch.where(metric >= threshold, tones[best], torch.full_like(metric, -1.0))
    return tone, metric


def ctcss_generate(tone_hz: float, n: int, sample_rate: float,
                   amplitude: float = 0.15, device=None) -> torch.Tensor:
    """amplitude·sin(2π·tone·t) on `device`, t the float32 arange(n) / fs."""
    t = _time(n, sample_rate, resolve_device(device))
    return amplitude * torch.sin(2.0 * np.pi * tone_hz * t)
