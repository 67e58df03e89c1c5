"""LoRa mesh networking (mesh/ re-design, ~8.5k LoC in the reference).

Meshtastic-style mesh: packet header with hop budget, flood + next-hop
routing (mesh/routing.rs), CSMA/CA medium access (mesh/mac.rs),
neighbor tables with SNR tracking (mesh/neighbor.rs),
store-and-forward for offline nodes (mesh/store_forward.rs),
traceroute (mesh/traceroute.rs), node telemetry (mesh/telemetry.rs),
and an event-driven multi-node simulation (mesh/simulation.rs;
family root mesh/mod.rs, traits in mesh/traits.rs, packets in
mesh/packet.rs).

The PHY layer is pluggable — `MeshSimulation` moves packets directly
with configurable link SNR/loss; pair with the LoRa modem for full
over-the-air simulation.

The port's counterpart of ``r4w_tpu.mesh``: host code, the reference's
rng (``np.random.default_rng(seed)``, one draw a delivery) and delivery
order. Wire bytes are host objects: `MeshPacket` computes its CRC-16 with
the port's `fec.crc.crc_compute` on the CPU, so a packet costs no device
launch. A round's wire frames go through `MeshSimulation._air` between
`MeshPacket.encode` and `MeshPacket.decode` as one batch: here it hands
them on as they are, and `mesh_gates.LoRaMeshSimulation` puts them through
the LoRa PHY on the card.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from collections import deque

import numpy as np

from r4w_tpu_torch.fec.crc import crc_compute
from r4w_tpu_torch.observe.logging import get_logger

log = get_logger("mesh")

BROADCAST = 0xFFFFFFFF
MAX_HOPS = 7


def _crc16(body: bytes) -> int:
    """CRC-16-CCITT of wire bytes, on the host."""
    return int(crc_compute(np.frombuffer(body, np.uint8).astype(np.int32), "crc16-ccitt",
                           device="cpu"))


@dataclasses.dataclass
class MeshPacket:
    """Wire header (mesh/packet.rs): src, dst, packet id, hop limit,
    want_ack, channel, payload + CRC16."""

    src: int
    dst: int
    packet_id: int
    hop_limit: int = 3
    want_ack: bool = False
    channel: int = 0
    payload: bytes = b""
    # routing metadata (not on the wire)
    rx_snr_db: float = 0.0
    relayed_by: tuple = ()

    _HDR = struct.Struct("<IIIBBB")

    def encode(self) -> bytes:
        hdr = self._HDR.pack(self.src, self.dst, self.packet_id,
                             self.hop_limit,
                             1 if self.want_ack else 0, self.channel)
        body = hdr + self.payload
        return body + struct.pack("<H", _crc16(body))

    @classmethod
    def decode(cls, raw: bytes) -> "MeshPacket | None":
        if len(raw) < cls._HDR.size + 2:
            return None
        body, crc_raw = raw[:-2], raw[-2:]
        if _crc16(body) != struct.unpack("<H", crc_raw)[0]:
            return None
        src, dst, pid, hops, ack, chan = cls._HDR.unpack(body[: cls._HDR.size])
        return cls(src=src, dst=dst, packet_id=pid, hop_limit=hops,
                   want_ack=bool(ack), channel=chan,
                   payload=body[cls._HDR.size:])


@dataclasses.dataclass
class Neighbor:
    node_id: int
    snr_db: float
    last_heard: float
    packets_heard: int = 1


class MeshNode:
    """One mesh participant (mesh/lora_mesh.rs): flood routing with
    duplicate suppression, neighbor table, optional next-hop routes,
    store-and-forward queue."""

    def __init__(self, node_id: int, hop_limit: int = 3):
        self.node_id = node_id
        self.hop_limit = hop_limit
        self.neighbors: dict[int, Neighbor] = {}
        self.routes: dict[int, int] = {}  # dst -> next hop
        self.seen: deque = deque(maxlen=256)
        self.store: dict[int, list[MeshPacket]] = {}  # offline dst -> queue
        self.inbox: list[MeshPacket] = []
        self.outbox: list[MeshPacket] = []
        self._next_id = node_id << 16
        self.stats = {"sent": 0, "relayed": 0, "received": 0, "dropped": 0}

    # -- TX ------------------------------------------------------------
    def send(self, dst: int, payload: bytes, want_ack: bool = False
             ) -> MeshPacket:
        self._next_id += 1
        pkt = MeshPacket(src=self.node_id, dst=dst,
                         packet_id=self._next_id,
                         hop_limit=min(self.hop_limit, MAX_HOPS),
                         want_ack=want_ack, payload=payload)
        self.outbox.append(pkt)
        self.seen.append(pkt.packet_id)
        self.stats["sent"] += 1
        return pkt

    def traceroute(self, dst: int) -> MeshPacket:
        """Traceroute request: relays append their ids (mesh/traceroute)."""
        return self.send(dst, b"\x01TRACE:", want_ack=True)

    # -- RX ------------------------------------------------------------
    def on_receive(self, pkt: MeshPacket, snr_db: float = 0.0,
                   now: float | None = None):
        now = now if now is not None else time.time()
        self._hear_neighbor(pkt, snr_db, now)
        if pkt.packet_id in self.seen:
            self.stats["dropped"] += 1
            return
        self.seen.append(pkt.packet_id)
        if pkt.dst in (self.node_id, BROADCAST):
            self.stats["received"] += 1
            self.inbox.append(pkt)
            if pkt.want_ack and pkt.dst == self.node_id:
                self.send(pkt.src, b"\x02ACK:" + struct.pack("<I", pkt.packet_id))
            if pkt.dst == self.node_id:
                return
        # relay (flood with hop decrement, mesh/routing.rs)
        if pkt.hop_limit > 0:
            relay = dataclasses.replace(
                pkt, hop_limit=pkt.hop_limit - 1,
                payload=(pkt.payload + struct.pack("<I", self.node_id)
                         if pkt.payload.startswith(b"\x01TRACE:") else pkt.payload),
                relayed_by=pkt.relayed_by + (self.node_id,),
            )
            self.outbox.append(relay)
            self.stats["relayed"] += 1

    def _hear_neighbor(self, pkt: MeshPacket, snr_db: float, now: float):
        last = pkt.relayed_by[-1] if pkt.relayed_by else pkt.src
        nb = self.neighbors.get(last)
        if nb:
            nb.snr_db = 0.8 * nb.snr_db + 0.2 * snr_db
            nb.last_heard = now
            nb.packets_heard += 1
        else:
            self.neighbors[last] = Neighbor(last, snr_db, now)
        # learn a route back to the source through this neighbor
        if pkt.src != self.node_id:
            self.routes[pkt.src] = last

    # -- store & forward -------------------------------------------------
    def store_for(self, dst: int, pkt: MeshPacket):
        self.store.setdefault(dst, []).append(pkt)

    def flush_store(self, dst: int) -> list[MeshPacket]:
        """Deliver queued packets when dst comes back (store_forward.rs)."""
        pkts = self.store.pop(dst, [])
        self.outbox.extend(pkts)
        return pkts


class MeshSimulation:
    """Multi-node mesh simulator (mesh/simulation.rs): a link matrix of
    SNR/loss, synchronous rounds moving outboxes to receivers."""

    def __init__(self, seed: int = 0):
        self.nodes: dict[int, MeshNode] = {}
        self.links: dict[tuple[int, int], tuple[float, float]] = {}
        self._rng = np.random.default_rng(seed)
        self.round = 0

    def add_node(self, node_id: int, **kw) -> MeshNode:
        node = MeshNode(node_id, **kw)
        self.nodes[node_id] = node
        return node

    def connect(self, a: int, b: int, snr_db: float = 10.0,
                loss: float = 0.0):
        self.links[(a, b)] = (snr_db, loss)
        self.links[(b, a)] = (snr_db, loss)

    def step(self) -> int:
        """One delivery round; returns packets moved."""
        self.round += 1
        moved = 0
        deliveries = []
        for nid, node in self.nodes.items():
            out, node.outbox = node.outbox, []
            for pkt in out:
                for (a, b), (snr, loss) in self.links.items():
                    if a != nid:
                        continue
                    if self._rng.random() < loss:
                        continue
                    deliveries.append((b, pkt, snr))
        # wire roundtrip to exercise encode/decode + CRC; the round's frames
        # cross the air together
        received = self._air([pkt.encode() for _, pkt, _ in deliveries],
                             [snr for _, _, snr in deliveries])
        for (b, pkt, snr), raw in zip(deliveries, received):
            parsed = MeshPacket.decode(raw)
            if parsed is None:
                continue
            parsed.relayed_by = pkt.relayed_by
            parsed.rx_snr_db = snr
            self.nodes[b].on_receive(parsed, snr, now=float(self.round))
            moved += 1
        return moved

    def _air(self, frames: list[bytes], snrs: list[float]) -> list[bytes]:
        """The round's wire frames as their receivers get them (one per
        delivery, in order; here unchanged)."""
        return frames

    def run(self, max_rounds: int = 10) -> int:
        total = 0
        for _ in range(max_rounds):
            moved = self.step()
            total += moved
            if moved == 0:
                break
        return total

    def status(self) -> dict:
        return {
            nid: {"neighbors": sorted(n.neighbors),
                  "routes": dict(n.routes), **n.stats}
            for nid, n in self.nodes.items()
        }
