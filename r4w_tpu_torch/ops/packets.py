"""Packet framing & protocol-decoder fills.

PyTorch counterpart of ``r4w_tpu.ops.packets`` (packet_encoder.rs /
packet_decoder.rs / packet_framing.rs / packet_header_parser.rs /
packet_sink.rs, header_payload_demux.rs, protocol_formatter.rs,
protocol_frame_parser.rs, telemetry_framer.rs,
ccsds_frame_processor.rs, dvb_s2_deframer.rs,
ieee_802154_zigbee_frame_parser.rs, pocsag_decoder.rs,
sigfox_decoder.rs, noaa_weather_decoder.rs, meteor_burst_decoder.rs,
psk31_codec.rs, random_pdu_gen.rs, tagged_stream_align.rs /
tagged_stream_mux.rs / tagged_stream_multiply_length.rs /
tagged_stream_pdu.rs, tag_debug.rs, tag_share.rs, tagged_file_sink.rs,
stream_to_tagged_stream.rs, header formats in file_meta.rs).

Framing and parsing are host byte work, the reference's numpy as it is;
their CRCs are the port's `fec.crc` on the host's CPU. The IQ-facing
pieces are torch on the samples' device: the APT envelope (one FIR launch
for I and Q), the burst detector (median rule), the POCSAG batch decode
(an int64 register masked to 32 bits, over leading axes). `random_pdu`
draws the reference's own threefry bytes. `pocsag_encode_numeric` keeps
the reference's limit: an address past 21 bits overflows its uint32
words and raises ``OverflowError``.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.hostio import magnitude
from r4w_tpu_torch.core.types import REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.fec import crc as _crc
from r4w_tpu_torch.ops import filters as _filters
from r4w_tpu_torch.ops.spectral2 import median


def _host_crc(data: np.ndarray, name: str) -> torch.Tensor:
    """The port's CRC of host bytes, computed on the host's CPU."""
    return _crc.crc_compute(np.array(data), name, device="cpu")


def _host(x) -> np.ndarray:
    """An array or tensor as a host numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------- generic packets

_SYNC_WORD = b"\x2d\xd4"  # classic CC11xx-style sync


def packet_encode(payload: bytes, sync: bytes = _SYNC_WORD,
                  whiten_seed: int | None = None) -> bytes:
    """Length-prefixed frame with sync + CRC-16 (packet_encoder.rs /
    packet_framing.rs): [sync][len][payload][crc16]."""
    payload = bytes(payload)
    if len(payload) > 255:
        raise ValueError("payload too long for 1-byte length prefix")
    body = bytes([len(payload)]) + payload
    crc = int(_host_crc(np.frombuffer(body, np.uint8), "crc16-ccitt"))
    return bytes(sync) + body + struct.pack(">H", crc)


def packet_decode(frame: bytes, sync: bytes = _SYNC_WORD):
    """Inverse of packet_encode; scans for sync, checks CRC
    (packet_decoder.rs / packet_header_parser.rs). Returns
    (payload | None, error)."""
    frame = bytes(frame)
    i = frame.find(bytes(sync))
    if i < 0:
        return None, "no sync"
    i += len(sync)
    if i >= len(frame):
        return None, "truncated"
    n = frame[i]
    body = frame[i:i + 1 + n]
    if len(body) < 1 + n or len(frame) < i + 1 + n + 2:
        return None, "truncated"
    want = struct.unpack(">H", frame[i + 1 + n:i + 3 + n])[0]
    got = int(_host_crc(np.frombuffer(body, np.uint8), "crc16-ccitt"))
    if want != got:
        return None, "crc"
    return body[1:], None


def header_payload_demux(frame: bytes, header_len: int):
    """Split a frame into header/payload (header_payload_demux.rs)."""
    frame = bytes(frame)
    return frame[:header_len], frame[header_len:]


@dataclasses.dataclass
class PacketSink:
    """Accumulate decoded packets (packet_sink.rs)."""
    packets: list = dataclasses.field(default_factory=list)
    errors: int = 0

    def push(self, frame: bytes, sync: bytes = _SYNC_WORD):
        p, err = packet_decode(frame, sync)
        if p is None:
            self.errors += 1
        else:
            self.packets.append(p)
        return p


def protocol_format(fields: dict, fmt: str = "kv") -> bytes:
    """Render a field dict to a wire text format
    (protocol_formatter.rs): 'kv' (k=v;) or 'json'."""
    if fmt == "kv":
        return ";".join(f"{k}={v}" for k, v in fields.items()).encode()
    if fmt == "json":
        return json.dumps(fields, sort_keys=True).encode()
    raise ValueError(f"unknown format '{fmt}'")


def protocol_parse(data: bytes, fmt: str = "kv") -> dict:
    """Inverse of protocol_format (protocol_frame_parser.rs)."""
    if fmt == "kv":
        out = {}
        for part in data.decode().split(";"):
            if "=" in part:
                k, v = part.split("=", 1)
                out[k] = v
        return out
    if fmt == "json":
        return json.loads(data.decode())
    raise ValueError(f"unknown format '{fmt}'")


def telemetry_frame(values, frame_id: int = 0) -> bytes:
    """Fixed-point telemetry frame (telemetry_framer.rs):
    [0xEB90][id][count][i16 values...][crc16]."""
    vals = np.asarray(values)
    scaled = np.clip(np.round(vals * 100.0), -32768, 32767).astype(">i2")
    body = struct.pack(">HBB", 0xEB90, frame_id & 0xFF,
                       scaled.shape[0]) + scaled.tobytes()
    crc = int(_host_crc(np.frombuffer(body, np.uint8), "crc16-ccitt"))
    return body + struct.pack(">H", crc)


def telemetry_parse(frame: bytes):
    if len(frame) < 6 or struct.unpack(">H", frame[:2])[0] != 0xEB90:
        return None
    fid, count = frame[2], frame[3]
    body, want = frame[:-2], struct.unpack(">H", frame[-2:])[0]
    if int(_host_crc(np.frombuffer(body, np.uint8),
                            "crc16-ccitt")) != want:
        return None
    vals = np.frombuffer(frame[4:4 + 2 * count], ">i2") / 100.0
    return fid, vals


def random_pdu(key, min_len: int = 8, max_len: int = 64):
    """Random-length random-content PDU (random_pdu_gen.rs) from a
    `channel.threefry` key: the key split in two, the length and the bytes
    drawn as the reference's ``jax.random.randint``, so the bytes are the
    reference's."""
    k1, k2 = threefry.split(key)
    n = int(threefry.randint(k1, (), min_len, max_len + 1))
    data = np.asarray(threefry.randint(k2, (n,), 0, 256), np.uint8).tobytes()
    return data


# ------------------------------------------------------------- CCSDS

CCSDS_ASM = b"\x1a\xcf\xfc\x1d"


def ccsds_frame_encode(payload: bytes, scid: int = 0x12,
                       vcid: int = 0) -> bytes:
    """CCSDS TM transfer frame (ccsds_frame_processor.rs): ASM +
    6-byte primary header + payload + CRC-16/CCITT."""
    hdr_w1 = ((0 & 0x3) << 14) | ((scid & 0x3FF) << 4) | ((vcid & 0x7)
                                                          << 1)
    header = struct.pack(">HHH", hdr_w1, 0x0000, 0x1800)
    body = header + bytes(payload)
    crc = int(_host_crc(np.frombuffer(body, np.uint8),
                               "crc16-ccitt"))
    return CCSDS_ASM + body + struct.pack(">H", crc)


def ccsds_frame_decode(frame: bytes):
    """Returns (scid, vcid, payload) or None on ASM/CRC failure."""
    frame = bytes(frame)
    i = frame.find(CCSDS_ASM)
    if i < 0:
        return None
    body = frame[i + 4:-2]
    want = struct.unpack(">H", frame[-2:])[0]
    if int(_host_crc(np.frombuffer(body, np.uint8),
                            "crc16-ccitt")) != want:
        return None
    w1 = struct.unpack(">H", body[:2])[0]
    return (w1 >> 4) & 0x3FF, (w1 >> 1) & 0x7, body[6:]


# ------------------------------------------------------------ DVB-S2

_DVB_MODCODS = {1: ("QPSK", "1/4"), 4: ("QPSK", "1/2"),
                11: ("8PSK", "3/5"), 17: ("16APSK", "2/3")}


def dvb_s2_bbheader(modcod: int, payload_len_bits: int) -> bytes:
    """Simplified DVB-S2 BBFRAME header (dvb_s2_deframer.rs
    counterpart): MATYPE/UPL/DFL/SYNC + CRC-8."""
    body = struct.pack(">BBHHB", 0xF0, modcod & 0xFF,
                       0, payload_len_bits & 0xFFFF, 0x47)
    crc = int(_host_crc(np.frombuffer(body, np.uint8),
                               "crc8")) & 0xFF
    return body + bytes([crc])


def dvb_s2_deframe(frame: bytes):
    """Parse the BBFRAME header → (modulation, rate, payload_bits) or
    None (dvb_s2_deframer.rs)."""
    if len(frame) < 8:
        return None
    body, crc = frame[:7], frame[7]
    if (int(_host_crc(np.frombuffer(body, np.uint8), "crc8"))
            & 0xFF) != crc:
        return None
    _, modcod, _, dfl, sync = struct.unpack(">BBHHB", body)
    if sync != 0x47:
        return None
    mod, rate = _DVB_MODCODS.get(modcod, ("?", "?"))
    return mod, rate, dfl


# ----------------------------------------------------- IEEE 802.15.4


def zigbee_frame_parse(frame: bytes):
    """IEEE 802.15.4 MAC header parse
    (ieee_802154_zigbee_frame_parser.rs): frame control, seq, PAN,
    addresses (16-bit short form), payload, FCS check (CRC-16/X.25
    polynomial with zero init per 802.15.4)."""
    frame = bytes(frame)
    if len(frame) < 5:
        return None
    fcf = struct.unpack("<H", frame[:2])[0]
    ftype = ("beacon", "data", "ack", "command")[fcf & 0x3] \
        if (fcf & 0x3) < 4 else "reserved"
    seq = frame[2]
    # FCS: CRC-16 (poly 0x1021 reflected, init 0) little-endian
    body, fcs = frame[:-2], struct.unpack("<H", frame[-2:])[0]
    crc = 0
    for byte in body:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    ok = crc == fcs
    off = 3
    dst_pan = dst = src = None
    if (fcf >> 10) & 0x3 == 2:      # short dst addressing
        dst_pan, dst = struct.unpack("<HH", frame[off:off + 4])
        off += 4
    if (fcf >> 14) & 0x3 == 2:      # short src addressing
        src = struct.unpack("<H", frame[off:off + 2])[0]
        off += 2
    return {"type": ftype, "seq": seq, "dst_pan": dst_pan, "dst": dst,
            "src": src, "payload": frame[off:-2], "fcs_ok": ok}


def zigbee_frame_build(payload: bytes, seq: int = 0, dst: int = 0xFFFF,
                       src: int = 0x0001, dst_pan: int = 0x1234) -> bytes:
    fcf = 0x1 | (2 << 10) | (2 << 14)   # data, short dst+src
    body = struct.pack("<HB", fcf, seq & 0xFF) \
        + struct.pack("<HH", dst_pan, dst) + struct.pack("<H", src) \
        + bytes(payload)
    crc = 0
    for byte in body:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return body + struct.pack("<H", crc)


# -------------------------------------------------------------- POCSAG

_POCSAG_SYNC = 0x7CD215D8
_POCSAG_IDLE = 0x7A89C197


def _pocsag_bch_encode(data21: int) -> int:
    """POCSAG codeword: 21 data bits + BCH(31,21) + even parity."""
    cw = data21 << 10
    poly = 0b11101101001
    reg = cw
    for i in range(30, 9, -1):
        if reg & (1 << i):
            reg ^= poly << (i - 10)
    cw |= reg & 0x3FF
    cw <<= 1
    cw |= bin(cw).count("1") & 1
    return cw


def pocsag_encode_numeric(address: int, digits: str,
                          function: int = 0) -> np.ndarray:
    """Encode one POCSAG batch: preamble-less [SC][frame codewords]
    with the address in its frame slot and BCD numeric message
    (pocsag_decoder.rs counterpart). Returns the 17×32-bit words."""
    frame = address & 0x7
    addr_data = ((address >> 3) << 2) | (function & 0x3)
    addr_cw = _pocsag_bch_encode(addr_data)
    bcd_map = {**{str(i): i for i in range(10)}, "*": 0xA, "U": 0xB,
               " ": 0xC, "-": 0xD, ")": 0xE, "(": 0xF}
    nibbles = [bcd_map[c] for c in digits]
    while len(nibbles) % 5:
        nibbles.append(0xC)
    msg_cws = []
    for i in range(0, len(nibbles), 5):
        data20 = 0
        for nb in nibbles[i:i + 5]:
            # each BCD digit transmitted LSB-first within the nibble
            rev = ((nb & 1) << 3) | ((nb & 2) << 1) \
                | ((nb & 4) >> 1) | ((nb & 8) >> 3)
            data20 = (data20 << 4) | rev
        msg_cws.append(_pocsag_bch_encode((1 << 20) | data20))
    words = [_POCSAG_SYNC]
    slot = 0
    for f in range(8):
        for h in range(2):
            if f == frame and h == 0:
                words.append(addr_cw)
            elif msg_cws and (f > frame or (f == frame and h == 1)):
                words.append(msg_cws.pop(0))
            else:
                words.append(_POCSAG_IDLE)
            slot += 1
    return np.asarray(words, np.uint32)


_POCSAG_INV_BCD = {0xA: "*", 0xB: "U", 0xC: " ", 0xD: "-", 0xE: ")",
                   0xF: "("}


def pocsag_decode(words):
    """Decode a POCSAG batch (pocsag_decoder.rs): find sync, pull the
    address codeword and BCD numeric message.

    Fixed-capacity form: returns `(addr int32, func int32, nibbles[80]
    int32, valid[80])` over words' leading axes (one batch of 17 words a
    row) — addr and func are -1 when no sync/address codeword is present;
    the 16 frame slots each contribute 5 BCD nibbles, `valid` True only on
    message-codeword slots. The 32-bit words sit in an int64 register
    masked to 32 bits (torch's uint32 lacks shifts), and the first address
    slot is the first True of the mask (an argmax, no host read).
    `pocsag_digits_to_str` maps the masked nibbles to the display string
    (host, protocol-object step)."""
    if isinstance(words, torch.Tensor):
        w = words.to(torch.int64) & 0xFFFFFFFF
    else:
        # host lists may carry Python ints >= 2^31 (the sync word)
        w = to_tensor((np.asarray(words, np.uint64) & 0xFFFFFFFF).astype(np.int64))
    sync_ok = w[..., 0] == _POCSAG_SYNC
    cw = w[..., 1:17]
    is_idle = cw == _POCSAG_IDLE
    data21 = cw >> 11            # strip BCH(10) + even-parity bit
    is_addr = (data21 >> 20) == 0
    slot = torch.arange(16, dtype=torch.int64, device=w.device)
    addr_cand = ((data21 >> 2) << 3) | (slot // 2)
    addr_mask = is_addr & ~is_idle & sync_ok[..., None]
    has_addr = torch.any(addr_mask, dim=-1)
    first = torch.argmax(addr_mask.to(torch.int32), dim=-1, keepdim=True)
    none = torch.full_like(has_addr, -1, dtype=torch.int32)
    addr = torch.where(has_addr, torch.gather(addr_cand, -1, first)[..., 0].to(torch.int32), none)
    func = torch.where(has_addr, (torch.gather(data21, -1, first)[..., 0] & 0x3).to(torch.int32),
                       none)
    # message codewords: 5 bit-reversed BCD nibbles each, MSB first
    data20 = data21 & 0xFFFFF
    sh = torch.arange(4, -1, -1, dtype=torch.int64, device=w.device) * 4
    rev = (data20[..., None] >> sh) & 0xF
    nb = (((rev & 1) << 3) | ((rev & 2) << 1)
          | ((rev & 4) >> 1) | ((rev & 8) >> 3))
    valid = (~is_addr & ~is_idle & sync_ok[..., None])[..., None].expand(nb.shape)
    lead = w.shape[:-1]
    return (addr, func,
            torch.where(valid, nb, 0).to(torch.int32).reshape(*lead, -1),
            valid.reshape(*lead, -1))


def pocsag_digits_to_str(nibbles, valid) -> str:
    """Display string from pocsag_decode's masked nibbles (host)."""
    out = [_POCSAG_INV_BCD.get(int(n), str(int(n)))
           for n, v in zip(_host(nibbles), _host(valid))
           if v]
    return "".join(out).rstrip()


# --------------------------------------------------------------- PSK31

_VARICODE = {
    " ": "1", "e": "11", "t": "101", "o": "111", "a": "1011",
    "i": "1101", "n": "1111", "r": "10101", "s": "10111", "l": "11011",
    "h": "101011", "d": "101101", "c": "101111", "u": "110101",
    "m": "111011", "f": "111101", "p": "111111", "g": "1011011",
    "y": "1011101", "b": "1011111", "w": "1101011", "v": "1101101",
    "k": "1101111", "x": "1110101", "q": "1110111", "j": "1111011",
    "z": "1111101", ".": "1010111", ",": "11101111", "?": "1010101011",
    "0": "10110111", "1": "10111101", "2": "11101101", "3": "11111111",
    "4": "101110111", "5": "101011011", "6": "101101011",
    "7": "110101101", "8": "110101011", "9": "110110111",
}
_VARICODE_INV = {v: k for k, v in _VARICODE.items()}


def psk31_encode(text: str) -> np.ndarray:
    """PSK31 varicode encode (psk31_codec.rs): characters separated by
    '00'; a varicode word never contains '00'."""
    bits = []
    for ch in text.lower():
        code = _VARICODE.get(ch, _VARICODE[" "])
        bits.extend(int(b) for b in code)
        bits.extend([0, 0])
    return np.asarray(bits, np.int64)


def psk31_decode(bits) -> str:
    b = "".join(str(int(x)) for x in np.asarray(bits))
    out = []
    for word in b.split("00"):
        word = word.strip("0")
        if word:
            out.append(_VARICODE_INV.get(word, "?"))
    return "".join(out)


# ---------------------------------------------------------- NOAA APT


def noaa_apt_lines(audio, sample_rate: float = 11025.0):
    """NOAA APT weather-fax decode (noaa_weather_decoder.rs): AM
    envelope of the 2.4 kHz subcarrier → 2 lines/s raster, sync-A
    aligned. Returns the (n_lines, width) image rows (uint8).

    I and Q are mixed with the float32 carrier phase the reference builds
    and low-passed in one (2, n) call of the FIR; the envelope's root is
    taken in float64 and rounded (torch's float32 root on the CPU is not
    correctly rounded), and the scaled image converts to uint8 by
    truncation, as the reference's cast does."""
    a = to_tensor(audio, REAL_DTYPE)
    n = a.shape[0]
    t = torch.arange(n, dtype=REAL_DTYPE, device=a.device) / real_scalar(sample_rate, a.device)
    ph = 2 * np.pi * 2400.0 * t
    iq = torch.stack([a * torch.cos(ph), a * torch.sin(ph)])
    lp = _filters.design_lowpass(63, 1200.0, sample_rate)
    f = _filters.fir_apply(lp, iq)
    env = 2.0 * torch.sqrt((f[0] ** 2 + f[1] ** 2).double()).to(REAL_DTYPE)
    width = int(sample_rate / 2)          # 0.5 s per line
    n_lines = env.shape[0] // width
    img = env[:n_lines * width].reshape(n_lines, width)
    mx = torch.max(img)
    # values in [0, 255]: the cast truncates toward zero, as the reference's
    return (img / torch.clamp(mx, min=1e-9) * 255.0).to(torch.uint8)


# ------------------------------------------------------- meteor burst


def meteor_burst_detect(x, frame: int = 256, open_db: float = 10.0):
    """Detect meteor-scatter bursts: short strong openings over the
    noise floor (meteor_burst_decoder.rs front end). Returns
    (burst_mask_per_frame, floor_db); the floor is the median frame
    power, the mean of the two middle values at an even count."""
    x = to_tensor(x)
    n = (x.shape[0] // frame) * frame
    p = torch.mean(magnitude(x[:n].reshape(-1, frame)) ** 2, dim=-1)
    p_db = 10.0 * torch.log10(torch.clamp(p, min=1e-30))
    floor = median(p_db)
    return p_db > floor + open_db, floor


# -------------------------------------------------------------- Sigfox


def sigfox_frame_build(dev_id: int, seq: int, payload: bytes) -> bytes:
    """Sigfox-style uplink frame (sigfox_decoder.rs counterpart):
    [preamble AAAAA][sync 0x35F][len|seq][devid LE32][payload][crc16]."""
    if len(payload) > 12:
        raise ValueError("sigfox payload <= 12 bytes")
    head = b"\xaa\xaa\xa3\x5f" + bytes([(len(payload) << 4)
                                        | (seq & 0xF)])
    body = head[4:] + struct.pack("<I", dev_id) + bytes(payload)
    crc = int(_host_crc(np.frombuffer(body, np.uint8), "crc16-ccitt"))
    return head + struct.pack("<I", dev_id) + bytes(payload) \
        + struct.pack(">H", crc)


def sigfox_frame_parse(frame: bytes):
    frame = bytes(frame)
    i = frame.find(b"\xa3\x5f")
    if i < 0 or len(frame) < i + 9:
        return None
    lb = frame[i + 2]
    n, seq = lb >> 4, lb & 0xF
    dev = struct.unpack("<I", frame[i + 3:i + 7])[0]
    payload = frame[i + 7:i + 7 + n]
    body = frame[i + 2:i + 7 + n]
    want = struct.unpack(">H", frame[i + 7 + n:i + 9 + n])[0]
    if int(_host_crc(np.frombuffer(body, np.uint8),
                            "crc16-ccitt")) != want:
        return None
    return dev, seq, payload


# ------------------------------------------------------- tagged streams


def tagged_stream_align(x, tags, key: str = "len"):
    """Drop samples before the first length tag
    (tagged_stream_align.rs). tags: list of (index, dict)."""
    starts = [i for i, meta in tags if key in meta]
    if not starts:
        return to_tensor(x)[0:0], []
    s0 = min(starts)
    shifted = [(i - s0, m) for i, m in tags if i >= s0]
    return to_tensor(x)[s0:], shifted


def tagged_stream_mux(segments):
    """Concatenate length-tagged segments, emitting per-segment tags
    (tagged_stream_mux.rs). Returns (stream, tags)."""
    tags = []
    off = 0
    parts = []
    for seg in segments:
        seg = to_tensor(seg)
        tags.append((off, {"len": int(seg.shape[0])}))
        off += int(seg.shape[0])
        parts.append(seg)
    return torch.cat(parts), tags


def tagged_stream_multiply_length(tags, factor: int):
    """Scale length tags after a rate change
    (tagged_stream_multiply_length.rs)."""
    return [(i * factor, {**m, "len": m["len"] * factor})
            for i, m in tags]


def tag_share(tags_a, tags_b):
    """Merge tag lists from two streams (tag_share.rs)."""
    return sorted(tags_a + tags_b, key=lambda t: t[0])


def tag_debug(tags) -> str:
    """Printable tag dump (tag_debug.rs)."""
    return "\n".join(f"@{i}: {m}" for i, m in tags)


def stream_to_tagged(x, frame_len: int, key: str = "len"):
    """Insert a length tag every frame (stream_to_tagged_stream.rs)."""
    x = to_tensor(x)
    tags = [(i, {key: frame_len})
            for i in range(0, int(x.shape[0]), frame_len)]
    return x, tags


def tagged_file_sink(path: str, x, tags):
    """Write stream + sidecar tag JSON (tagged_file_sink.rs)."""
    arr = _host(x)
    arr.tofile(path)
    with open(path + ".tags.json", "w") as f:
        json.dump([[int(i), m] for i, m in tags], f)
    return path


def file_meta_write(path: str, x, meta: dict):
    """Raw samples + JSON metadata header file (file_meta.rs)."""
    arr = _host(x)
    with open(path + ".meta.json", "w") as f:
        json.dump({"dtype": str(arr.dtype), "shape": list(arr.shape),
                   **meta}, f)
    arr.tofile(path)
    return path


def file_meta_read(path: str):
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    arr = np.fromfile(path, dtype=np.dtype(meta["dtype"]))
    return arr.reshape(meta["shape"]), meta


BLOCKS = {
    "packet_encoder": ("packet_encode", "modulator",
                       "sync+len+CRC framing (packet_encoder.rs)"),
    "packet_decoder": ("packet_decode", "demodulator",
                       "frame scan + CRC check (packet_decoder.rs)"),
    "packet_sink": ("PacketSink", "sink",
                    "decoded-packet accumulator (packet_sink.rs)"),
    "header_payload_demux": ("header_payload_demux", "demodulator",
                             "header/payload split "
                             "(header_payload_demux.rs)",
                             ("header_len",)),
    "protocol_formatter": ("protocol_format", "math",
                           "kv/json field render "
                           "(protocol_formatter.rs)", ("fmt",)),
    "protocol_frame_parser": ("protocol_parse", "math",
                              "kv/json field parse "
                              "(protocol_frame_parser.rs)", ("fmt",)),
    "telemetry_framer": ("telemetry_frame", "modulator",
                         "fixed-point telemetry frame "
                         "(telemetry_framer.rs)", ("frame_id",)),
    "random_pdu_gen": ("random_pdu", "source",
                       "random PDUs (random_pdu_gen.rs)",
                       ("min_len", "max_len")),
    "ccsds_frame": ("ccsds_frame_encode", "modulator",
                    "CCSDS TM frame + ASM + CRC "
                    "(ccsds_frame_processor.rs)", ("scid", "vcid")),
    "dvb_s2_deframer": ("dvb_s2_deframe", "demodulator",
                        "BBFRAME header parse (dvb_s2_deframer.rs)"),
    "zigbee_frame_parser": ("zigbee_frame_parse", "demodulator",
                            "802.15.4 MAC parse + FCS "
                            "(ieee_802154_zigbee_frame_parser.rs)"),
    "pocsag_decoder": ("pocsag_decode", "demodulator",
                       "POCSAG batch decode w/ BCH(31,21) codewords "
                       "(pocsag_decoder.rs)"),
    "psk31_codec": ("psk31_encode", "modulator",
                    "PSK31 varicode (psk31_codec.rs)"),
    "noaa_weather_decoder": ("noaa_apt_lines", "demodulator",
                             "NOAA APT raster decode "
                             "(noaa_weather_decoder.rs)",
                             ("sample_rate",)),
    "meteor_burst_decoder": ("meteor_burst_detect", "demodulator",
                             "meteor-scatter burst openings "
                             "(meteor_burst_decoder.rs)",
                             ("frame", "open_db")),
    "sigfox_decoder": ("sigfox_frame_parse", "demodulator",
                       "Sigfox uplink frame parse (sigfox_decoder.rs)"),
    "tagged_stream_align": ("tagged_stream_align", "math",
                            "align to first length tag "
                            "(tagged_stream_align.rs)"),
    "tagged_stream_mux": ("tagged_stream_mux", "math",
                          "concat length-tagged segments "
                          "(tagged_stream_mux.rs)"),
    "tagged_stream_multiply_length": (
        "tagged_stream_multiply_length", "math",
        "scale length tags (tagged_stream_multiply_length.rs)",
        ("factor",)),
    "tag_share": ("tag_share", "math", "merge tag lists (tag_share.rs)"),
    "tag_debug": ("tag_debug", "sink", "tag dump (tag_debug.rs)"),
    "stream_to_tagged_stream": ("stream_to_tagged", "math",
                                "periodic length tags "
                                "(stream_to_tagged_stream.rs)",
                                ("frame_len",)),
    "tagged_file_sink": ("tagged_file_sink", "sink",
                         "samples + tag sidecar (tagged_file_sink.rs)"),
    "file_meta": ("file_meta_write", "sink",
                  "samples + JSON metadata (file_meta.rs)"),
}
