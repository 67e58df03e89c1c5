"""Meshtastic wire-format interop: 16-byte radio header, AES-256-CTR
channel crypto, and next-hop routing.

Re-design of mesh/wire/mod.rs + wire/header.rs, mesh/crypto.rs,
mesh/routing.rs, mesh/meshtastic.rs (the depth
VERDICT r1 item 8 flags as missing from mesh.py's flood-only core):

* **Wire header** (wire/header.rs:1-28): 16 bytes, little-endian —
  to(4) | from(4) | id(4) | flags(1) | channel_hash(1) | next_hop(1) |
  relay_node(1); flags = hop_limit:3 | want_ack:1 | via_mqtt:1 |
  hop_start:3.
* **Channel crypto** (crypto.rs): PSK→AES-256 key (32B direct, 16B
  zero-padded, 1B index expanded from the well-known DEFAULT_PSK;
  index 0 = unencrypted), channel hash = xorFold(name) ^ xorFold(key),
  AES-256-CTR with big-endian counter and the firmware nonce layout
  (packet_id u64 LE at 0..8, source u32 LE at 8..12, zeros elsewhere).
  No MIC — Meshtastic CTR mode leaves the post-header bytes as raw
  ciphertext (meshtastic.rs:623).
* **Routing** (routing.rs): managed flood for broadcasts plus a
  NextHopRouter that learns routes from overheard traffic
  (hops = hop_start − hop_limit + 1), serves next-hop lookups for
  direct packets, and falls back to flooding when no route is known.

The `r4w_tpu_torch.mesh` module keeps the PHY-agnostic simulation;
this module provides byte-level interop so frames round-trip against
real Meshtastic captures.

The port's copy of ``r4w_tpu.mesh_meshtastic``: host code on bytes, the
reference's line for line with its imports pointed at the port. The
``cryptography`` package is imported inside `CryptoContext._cipher`, so
the module imports on a machine without it (an unencrypted channel key,
``ChannelKey(psk=b"\x00")``, never reaches it).
"""

from __future__ import annotations

import dataclasses
import struct
import time

WIRE_HEADER_SIZE = 16
BROADCAST = 0xFFFFFFFF

# Well-known default channel PSK (crypto.rs:38-41)
DEFAULT_PSK = bytes([
    0xD4, 0xF1, 0xBB, 0x3A, 0x20, 0x29, 0x07, 0x59,
    0xF0, 0xBC, 0xFF, 0xAB, 0xCF, 0x4E, 0x69, 0x01,
])

# Modem presets (meshtastic.rs:42-66): name -> (SF, bandwidth Hz, CR)
MODEM_PRESETS = {
    "LongFast": (11, 250_000.0, 5),
    "LongSlow": (12, 125_000.0, 8),
    "LongModerate": (11, 125_000.0, 8),
    "MediumFast": (9, 250_000.0, 5),
    "MediumSlow": (10, 250_000.0, 5),
    "ShortFast": (7, 250_000.0, 5),
    "ShortSlow": (8, 250_000.0, 5),
}


def xor_fold(data: bytes) -> int:
    """Meshtastic firmware xorHash: XOR of all bytes (crypto.rs:183)."""
    h = 0
    for b in data:
        h ^= b
    return h


@dataclasses.dataclass
class WireHeader:
    """The 16-byte on-air Meshtastic header (wire/header.rs)."""

    to: int
    from_: int
    id: int
    hop_limit: int = 3
    want_ack: bool = False
    via_mqtt: bool = False
    hop_start: int = 3
    channel_hash: int = 0
    next_hop: int = 0
    relay_node: int = 0

    _FMT = struct.Struct("<IIIBBBB")

    @property
    def flags(self) -> int:
        return ((self.hop_limit & 0x07)
                | (0x08 if self.want_ack else 0)
                | (0x10 if self.via_mqtt else 0)
                | ((self.hop_start & 0x07) << 5))

    def to_bytes(self) -> bytes:
        return self._FMT.pack(self.to, self.from_, self.id, self.flags,
                              self.channel_hash & 0xFF,
                              self.next_hop & 0xFF,
                              self.relay_node & 0xFF)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "WireHeader":
        if len(raw) < WIRE_HEADER_SIZE:
            raise ValueError("wire header needs 16 bytes")
        to, frm, pid, flags, ch, nh, relay = cls._FMT.unpack(
            raw[:WIRE_HEADER_SIZE])
        return cls(to=to, from_=frm, id=pid,
                   hop_limit=flags & 0x07,
                   want_ack=bool(flags & 0x08),
                   via_mqtt=bool(flags & 0x10),
                   hop_start=(flags >> 5) & 0x07,
                   channel_hash=ch, next_hop=nh, relay_node=relay)

    @classmethod
    def broadcast(cls, from_: int, id: int, hop_limit: int,
                  channel_hash: int) -> "WireHeader":
        return cls(to=BROADCAST, from_=from_, id=id, hop_limit=hop_limit,
                   hop_start=hop_limit, channel_hash=channel_hash)


class ChannelKey:
    """PSK → 32-byte AES-256 key, Meshtastic semantics (crypto.rs:51-131).

    - 32-byte PSK: used directly
    - 16-byte PSK: zero-padded to 32
    - 1-byte PSK: index expansion — 0 = unencrypted, 1 = DEFAULT_PSK,
      k>1 = DEFAULT_PSK with its last byte replaced by k
    - None: DEFAULT_PSK
    """

    def __init__(self, channel_name: str = "LongFast",
                 psk: bytes | None = None):
        self.channel_name = channel_name
        if psk is None:
            psk = DEFAULT_PSK
        if len(psk) == 1:
            index = psk[0]
            if index == 0:
                self.key = b"\x00" * 32
                self.encrypted = False
                return
            base = bytearray(DEFAULT_PSK)
            if index > 1:
                base[-1] = index
            psk = bytes(base)
        if len(psk) == 16:
            psk = psk + b"\x00" * 16
        if len(psk) != 32:
            raise ValueError(f"invalid PSK length {len(psk)}")
        self.key = psk
        self.encrypted = any(self.key)

    def channel_hash(self) -> int:
        """xorFold(name) ^ xorFold(key) (crypto.rs:182-186)."""
        return xor_fold(self.channel_name.encode()) ^ xor_fold(self.key)


def make_nonce(packet_id: int, source: int) -> bytes:
    """Firmware CryptoEngine::initNonce layout (crypto.rs:241-251)."""
    return (struct.pack("<Q", packet_id & 0xFFFFFFFFFFFFFFFF)
            + struct.pack("<I", source & 0xFFFFFFFF)
            + b"\x00" * 4)


class CryptoContext:
    """AES-256-CTR packet crypto (crypto.rs CryptoContext)."""

    def __init__(self, key: ChannelKey):
        self.key = key

    def channel_hash(self) -> int:
        return self.key.channel_hash()

    def _cipher(self, packet_id: int, source: int):
        from cryptography.hazmat.primitives.ciphers import (
            Cipher, algorithms, modes)

        nonce = make_nonce(packet_id, source)
        return Cipher(algorithms.AES(self.key.key), modes.CTR(nonce))

    def encrypt(self, plaintext: bytes, packet_id: int,
                source: int) -> bytes:
        if not self.key.encrypted:
            return plaintext
        enc = self._cipher(packet_id, source).encryptor()
        return enc.update(plaintext) + enc.finalize()

    def decrypt(self, ciphertext: bytes, packet_id: int,
                source: int) -> bytes:
        # CTR decryption == encryption
        return self.encrypt(ciphertext, packet_id, source)


class MeshtasticCodec:
    """Frame encode/decode: header in clear, payload CTR-encrypted
    (meshtastic.rs:516-608)."""

    def __init__(self, channel: ChannelKey | None = None):
        self.channel = channel or ChannelKey()
        self.crypto = CryptoContext(self.channel)

    def encode(self, header: WireHeader, payload: bytes) -> bytes:
        header.channel_hash = self.channel.channel_hash()
        return (header.to_bytes()
                + self.crypto.encrypt(payload, header.id, header.from_))

    def decode(self, frame: bytes) -> tuple[WireHeader, bytes]:
        if len(frame) < WIRE_HEADER_SIZE + 1:
            raise ValueError("frame too short")
        header = WireHeader.from_bytes(frame)
        if header.channel_hash != self.channel.channel_hash():
            raise ValueError(
                f"channel hash mismatch: {header.channel_hash:#x} != "
                f"{self.channel.channel_hash():#x}")
        payload = self.crypto.decrypt(frame[WIRE_HEADER_SIZE:],
                                      header.id, header.from_)
        return header, payload


# ------------------------------------------------------------ routing


@dataclasses.dataclass
class Route:
    """A learned route (routing.rs:52-95)."""

    destination: int
    next_hop: int
    hop_count: int
    quality: float
    learned_at: float = dataclasses.field(default_factory=time.monotonic)

    def is_expired(self, timeout_s: float) -> bool:
        return time.monotonic() - self.learned_at > timeout_s

    def touch(self):
        self.learned_at = time.monotonic()


class RoutingTable:
    """Bounded route cache with expiry + worst-first eviction
    (routing.rs RoutingTable)."""

    def __init__(self, timeout_s: float = 3600.0, max_routes: int = 128):
        self.timeout_s = timeout_s
        self.max_routes = max_routes
        self.routes: dict[int, Route] = {}

    def update(self, route: Route):
        old = self.routes.get(route.destination)
        # keep a better (fewer hops or higher quality) fresh route
        if old and not old.is_expired(self.timeout_s):
            if (old.hop_count, -old.quality) <= (route.hop_count,
                                                 -route.quality):
                old.touch()
                return
        if (len(self.routes) >= self.max_routes
                and route.destination not in self.routes):
            self._evict_worst()
        self.routes[route.destination] = route

    def get(self, destination: int) -> Route | None:
        r = self.routes.get(destination)
        if r and r.is_expired(self.timeout_s):
            del self.routes[destination]
            return None
        return r

    def prune(self) -> int:
        dead = [d for d, r in self.routes.items()
                if r.is_expired(self.timeout_s)]
        for d in dead:
            del self.routes[d]
        return len(dead)

    def _evict_worst(self):
        if self.routes:
            worst = max(self.routes.values(),
                        key=lambda r: (r.hop_count, -r.quality))
            del self.routes[worst.destination]

    def __len__(self) -> int:
        return len(self.routes)


class NextHopRouter:
    """Learn routes from overheard packets; serve next hops
    (routing.rs:465-537)."""

    def __init__(self, node_id: int, timeout_s: float = 3600.0):
        self.node_id = node_id
        self.routes = RoutingTable(timeout_s)

    def learn_route(self, header: WireHeader, from_neighbor: int,
                    quality: float = 1.0):
        if header.from_ == self.node_id:
            return
        hop_start = max(header.hop_start, header.hop_limit)
        hops = hop_start - header.hop_limit + 1
        self.routes.update(Route(header.from_, from_neighbor, hops, quality))

    def next_hop(self, destination: int) -> int | None:
        r = self.routes.get(destination)
        return r.next_hop if r else None

    def route_count(self) -> int:
        return len(self.routes)


class MeshtasticNode:
    """A wire-compatible node: flood for broadcast, next-hop for direct
    (meshtastic.rs MeshtasticNode role, PHY left to the caller)."""

    def __init__(self, node_id: int, channel: ChannelKey | None = None,
                 hop_limit: int = 3):
        self.node_id = node_id
        self.codec = MeshtasticCodec(channel)
        self.router = NextHopRouter(node_id)
        self.hop_limit = hop_limit
        self._next_id = (node_id * 2654435761) & 0x7FFFFFFF
        self.seen: set[tuple[int, int]] = set()
        self.received: list[tuple[WireHeader, bytes]] = []
        self.tx_count = 0

    def _packet_id(self) -> int:
        self._next_id = (self._next_id + 1) & 0xFFFFFFFF
        return self._next_id

    def send(self, to: int, payload: bytes) -> bytes:
        """Build a frame; direct packets carry next_hop when a route is
        known (low byte of the next node id, firmware convention)."""
        hdr = WireHeader(to=to, from_=self.node_id, id=self._packet_id(),
                         hop_limit=self.hop_limit,
                         hop_start=self.hop_limit)
        if to != BROADCAST:
            nh = self.router.next_hop(to)
            if nh is not None:
                hdr.next_hop = nh & 0xFF
        self.seen.add((hdr.from_, hdr.id))
        self.tx_count += 1
        return self.codec.encode(hdr, payload)

    def on_receive(self, frame: bytes, from_neighbor: int,
                   snr_db: float = 10.0) -> bytes | None:
        """Process an incoming frame; returns a relay frame or None."""
        try:
            hdr, payload = self.codec.decode(frame)
        except ValueError:
            return None
        key = (hdr.from_, hdr.id)
        if key in self.seen:
            return None
        self.seen.add(key)
        quality = min(1.0, max(0.05, (snr_db + 20.0) / 30.0))
        self.router.learn_route(hdr, from_neighbor, quality)

        if hdr.to in (self.node_id, BROADCAST):
            self.received.append((hdr, payload))
            if hdr.to == self.node_id:
                return None
        if hdr.hop_limit == 0:
            return None
        # relay: for routed packets only the named next hop relays
        if (hdr.to != BROADCAST and hdr.next_hop
                and hdr.next_hop != (self.node_id & 0xFF)):
            return None
        relay = dataclasses.replace(hdr)
        relay.hop_limit -= 1
        relay.relay_node = self.node_id & 0xFF
        if relay.to != BROADCAST:
            nh = self.router.next_hop(relay.to)
            relay.next_hop = (nh & 0xFF) if nh is not None else 0
        self.tx_count += 1
        return self.codec.encode(relay, payload)


# ------------------------------------------------------------ app layer
# Protobuf Data envelope helpers (meshtastic.rs:730-785, the
# `meshtastic-interop` feature; codec in r4w_tpu_torch.mesh_proto).

def _app_send(node: MeshtasticNode, to: int, data) -> bytes:
    from r4w_tpu_torch.mesh_proto import Data
    assert isinstance(data, Data)
    return node.send(to, data.encode())


def send_text(node: MeshtasticNode, message: str,
              to: int = BROADCAST) -> bytes:
    """Wrap text in a protobuf Data (PortNum.TEXT) and build the frame
    (meshtastic.rs:732-745)."""
    from r4w_tpu_torch.mesh_proto import Data
    return _app_send(node, to, Data.text(message))


def send_position(node: MeshtasticNode, lat: float, lon: float,
                  alt: int = 0, to: int = BROADCAST) -> bytes:
    """Position via protobuf (meshtastic.rs:748-754)."""
    from r4w_tpu_torch.mesh_proto import Data, Position
    return _app_send(node, to, Data.position(
        Position.from_coords(lat, lon, alt)))


def send_nodeinfo(node: MeshtasticNode, short_name: str, long_name: str,
                  to: int = BROADCAST) -> bytes:
    """User/NodeInfo via protobuf (meshtastic.rs:757-765)."""
    from r4w_tpu_torch.mesh_proto import Data, User
    return _app_send(node, to, Data.user(User.new(
        f"!{node.node_id:08x}", short_name, long_name)))


def send_telemetry(node: MeshtasticNode, telemetry,
                   to: int = BROADCAST) -> bytes:
    """Telemetry via protobuf (meshtastic.rs:770-780)."""
    from r4w_tpu_torch.mesh_proto import Data
    return _app_send(node, to, Data.telemetry(telemetry))


def classify_received(node: MeshtasticNode):
    """Decode every received payload through the protobuf layer:
    [(header, PortNum, decoded payload bytes or object)]
    (meshtastic.rs:600-671 receive path)."""
    from r4w_tpu_torch.mesh_proto import Data, PortNum, classify_payload
    out = []
    for hdr, payload in node.received:
        port, inner = classify_payload(payload)
        d = Data(portnum=int(port), payload=inner)
        decoded = (d.decode_text() or d.decode_position()
                   or d.decode_user() or d.decode_telemetry())
        out.append((hdr, port, decoded if decoded is not None else inner))
    return out
