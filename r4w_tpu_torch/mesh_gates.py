"""The LoRa mesh's gate: a Meshtastic ``LongFast`` mesh flooding over the
LoRa PHY on the card.

`mesh_lora_gate(device)` pairs the port's `mesh.MeshSimulation` with the
port's LoRa modem, as the reference's module docstring says it may
(``r4w_tpu/mesh.py:12-14``: "pair with the LoRa modem for full
over-the-air simulation"). Each round is `MeshSimulation.step` in the
reference's delivery order, with the PHY between `MeshPacket.encode` and
`MeshPacket.decode` (`LoRaMeshSimulation._air`).

The network (`GATE`, a `MeshScene`):

- PHY: Meshtastic's ``LongFast`` preset (`mesh_meshtastic.MODEM_PRESETS`:
  SF11, 250 kHz, CR 4/5) at one sample a chip, each wire frame in a LoRa
  packet with its explicit header and CRC (`waveforms.lora.packet`).
- 16 nodes on a 4 × 4 grid. The 24 links between horizontal and vertical
  neighbours take an SNR uniform on [−20, −6] dB, the 18 diagonal links one
  uniform on [−24, −14] dB, drawn once from ``np.random.default_rng(21)``;
  no link loses a frame at random (``loss`` 0): the PHY alone decides.
  SF11's demodulation floor is about −17.5 dB.
- Hop limit 3, Meshtastic's default and `MeshNode`'s.
- Traffic, every payload a Meshtastic frame (`mesh_meshtastic`) on the
  unencrypted channel ``ChannelKey("LongFast", b"\\x00")``: nodes 0-7 each
  send one text of 12-64 characters to a destination, both from the same
  generator (nodes 0-3 want an ACK); node 0 broadcasts a ``Position`` and a
  ``Telemetry``; the last node sends a traceroute (`MeshNode.traceroute`)
  to node 0. The simulation runs until a round moves nothing, at most 10
  rounds.

Each round on the device, batch-first: every delivery's LoRa packet is
padded with zero bytes to the round's longest (`parse_packet` reads the
length from the header, so the pad is never parsed); all rows are
modulated in one `modem.modulate(..., include_preamble=False)` call; AWGN
at each link's SNR is added row by row over the delivery's own symbols
(the pad's symbols stay clean), the noise drawn with the threefry key
``fold_in(fold_in(key(21), round), delivery index)`` (real part from its
first split, imaginary from its second, as `channel.awgn` draws a key), all
rows in one pass, so the card and the CPU add the same noise; all rows are demodulated in one
`modem.demodulate` call (one dechirp launch a round, on (rows · S, 2048)).
The receiver is frame-aligned, as `modem.loopback_ber` is: the rounds are
slots. The frames are parsed on the host: the LoRa CRC, then
`MeshPacket.decode`'s; a frame that fails either is dropped, as the
reference drops a ``None``.

Bars (`mesh_lora_gate`): every frame on a link at −12 dB or better comes
back with both CRCs good; every text that reaches its destination decodes
through `MeshtasticCodec.decode` and `mesh_proto.Data` to the text sent;
the traceroute's payload, where it reaches node 0, lists its relays in
order (at the drawn SNRs it may not: node 0 is three diagonal hops from
the last node, and diagonal links sit around SF11's floor; at +10 dB it
must arrive); every ``want_ack`` sender whose text arrived holds the ACK;
with every link at +10 dB, the final `status()` equals the PHY-less
`MeshSimulation` on the same traffic, and the payload bars hold there too.
Card = CPU is held by `compare_runs` on the `outcome`s of two runs of one
scene.
"""

from __future__ import annotations

import dataclasses
import struct
import time

import numpy as np
import torch

from r4w_tpu_torch.channel import awgn, threefry
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, REAL_DTYPE, resolve_device
from r4w_tpu_torch.mesh import BROADCAST, MeshSimulation
from r4w_tpu_torch.mesh_meshtastic import (MODEM_PRESETS, ChannelKey, MeshtasticCodec,
                                           MeshtasticNode, send_position, send_telemetry,
                                           send_text)
from r4w_tpu_torch.mesh_proto import Data, DeviceMetrics, Telemetry
from r4w_tpu_torch.waveforms.lora import modem
from r4w_tpu_torch.waveforms.lora.packet import build_packet, parse_packet
from r4w_tpu_torch.waveforms.lora.params import LoRaParams

SEED = 21                    # the links' SNRs, the traffic, the noise, the simulation's rng
HOP_LIMIT = 3                # Meshtastic's default and MeshNode's
MAX_ROUNDS = 10
NOISE_PASS = 1 << 20         # noise samples drawn in one pass (`noise_rows`)
STRONG_DB = -12.0            # every frame on a link this strong must come back
HIGH_SNR_DB = 10.0           # the PHY-loses-nothing run
TRACE_PREFIX = b"\x01TRACE:"
ACK_PREFIX = b"\x02ACK:"
TEXT_CHARS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,!?-",
                           np.uint8)
POSITION = (47.6205, -122.3493, 56)      # lat, lon, alt (m)
TELEMETRY = Telemetry(time=1_700_000_000, variant=DeviceMetrics(
    battery_level=87, voltage=3.97, channel_utilization=12.5, air_util_tx=1.25,
    uptime_seconds=86_400))


@dataclasses.dataclass(frozen=True)
class MeshScene:
    """A grid mesh and its traffic (module docstring)."""

    rows: int = 4
    cols: int = 4
    preset: str = "LongFast"
    axial_snr_db: tuple[float, float] = (-20.0, -6.0)
    diagonal_snr_db: tuple[float, float] = (-24.0, -14.0)
    link_snr_db: float | None = None      # every link at this SNR instead of the draws
    texts: int = 8                        # nodes 0 .. texts-1 send a text
    acks: int = 4                         # nodes 0 .. acks-1 want an ACK

    @property
    def nodes(self) -> int:
        return self.rows * self.cols

    def lora_params(self) -> LoRaParams:
        sf, bw_hz, cr_denominator = MODEM_PRESETS[self.preset]
        return LoRaParams(sf=sf, bw_hz=int(bw_hz), cr=cr_denominator - 4)


GATE = MeshScene()
CHANNEL = ChannelKey("LongFast", b"\x00")


def scene_links(scene: MeshScene, rng: np.random.Generator) -> list[tuple[int, int, float]]:
    """The grid's links in connect order, (a, b, SNR dB): the axial links
    row-major (right, then down), then the diagonals (down-right, then
    down-left); SNRs drawn in that order."""
    def node(r, c):
        return r * scene.cols + c

    axial, diagonal = [], []
    for r in range(scene.rows):
        for c in range(scene.cols):
            if c + 1 < scene.cols:
                axial.append((node(r, c), node(r, c + 1)))
            if r + 1 < scene.rows:
                axial.append((node(r, c), node(r + 1, c)))
    for r in range(scene.rows - 1):
        for c in range(scene.cols):
            if c + 1 < scene.cols:
                diagonal.append((node(r, c), node(r + 1, c + 1)))
            if c > 0:
                diagonal.append((node(r, c), node(r + 1, c - 1)))
    snr_ax = rng.uniform(*scene.axial_snr_db, len(axial))
    snr_dg = rng.uniform(*scene.diagonal_snr_db, len(diagonal))
    links = [(a, b, float(s)) for (a, b), s in zip(axial, snr_ax)]
    links += [(a, b, float(s)) for (a, b), s in zip(diagonal, snr_dg)]
    if scene.link_snr_db is not None:
        links = [(a, b, float(scene.link_snr_db)) for a, b, _ in links]
    return links


def build_simulation(scene: MeshScene, sim: MeshSimulation) -> list[dict]:
    """Add `scene`'s nodes, links and traffic to `sim` (its sends queued in
    the nodes' outboxes). Returns the traffic: one dict a send with its
    source, destination, kind, Meshtastic frame (or the traceroute's
    payload), packet id and want_ack."""
    rng = np.random.default_rng(SEED)
    for nid in range(scene.nodes):
        sim.add_node(nid, hop_limit=HOP_LIMIT)
    for a, b, snr in scene_links(scene, rng):
        sim.connect(a, b, snr_db=snr)
    radios = {nid: MeshtasticNode(nid, CHANNEL, hop_limit=HOP_LIMIT)
              for nid in range(scene.nodes)}
    traffic = []

    def queue(src, dst, kind, frame, want_ack=False, text=None):
        pkt = sim.nodes[src].send(dst, frame, want_ack=want_ack)
        traffic.append({"src": src, "dst": dst, "kind": kind, "frame": frame, "text": text,
                        "packet_id": pkt.packet_id, "want_ack": want_ack})

    for src in range(scene.texts):
        n = int(rng.integers(12, 65))
        text = bytes(rng.choice(TEXT_CHARS, n)).decode()
        dst = int(rng.choice([d for d in range(scene.nodes) if d != src]))
        queue(src, dst, "text", send_text(radios[src], text, to=dst),
              want_ack=src < scene.acks, text=text)
    queue(0, BROADCAST, "position", send_position(radios[0], *POSITION))
    queue(0, BROADCAST, "telemetry", send_telemetry(radios[0], TELEMETRY))
    last = scene.nodes - 1
    pkt = sim.nodes[last].traceroute(0)
    traffic.append({"src": last, "dst": 0, "kind": "traceroute", "frame": pkt.payload,
                    "text": None, "packet_id": pkt.packet_id, "want_ack": True})
    return traffic


def noise_rows(key, lengths: list[int], n: int, device) -> torch.Tensor:
    """Unit complex Gaussian noise (rows, n): row r drawn with
    ``fold_in(key, r)`` over its first ``lengths[r]`` samples (the real part
    from the key's first split, the imaginary from its second), zeros after.
    Consecutive rows are drawn together (`threefry.normal_segments`), up to
    `NOISE_PASS` samples a pass: one pass a row costs ~500 launches, and
    one over a whole round makes host tensors so large that their page
    faults dominate."""
    splits = [threefry.split(threefry.fold_in(key, r)) for r in range(len(lengths))]
    noise = torch.zeros((len(lengths), n), dtype=IQ_DTYPE, device=device)
    cols = torch.arange(n, device=device)[None, :]
    start = 0
    while start < len(lengths):
        stop, total = start + 1, lengths[start]
        while stop < len(lengths) and total + lengths[stop] <= NOISE_PASS:
            total += lengths[stop]
            stop += 1
        part = lengths[start:stop]
        re = threefry.normal_segments([k for k, _ in splits[start:stop]], part, device)
        im = threefry.normal_segments([k for _, k in splits[start:stop]], part, device)
        inside = cols < torch.tensor(part, device=device)[:, None]
        noise[start:stop][inside] = torch.complex(re, im)
        start = stop
    return noise


class LoRaMeshSimulation(MeshSimulation):
    """`MeshSimulation` whose rounds cross the LoRa PHY on `device` (module
    docstring). `deliveries` records every delivery: round, link SNR,
    outcome ("ok", "lora_crc", "header", "miscorrected") and the bytes
    received; `air` records each round's frames, SNRs, rows, samples and
    seconds."""

    def __init__(self, seed: int, params: LoRaParams, device, noise_seed: int):
        super().__init__(seed)
        self.params = params
        self.device = resolve_device(device)
        self.noise_key = threefry.key(noise_seed)
        self.deliveries: list[dict] = []
        self.air: list[dict] = []

    def _air(self, frames: list[bytes], snrs: list[float]) -> list[bytes]:
        if not frames:
            return []
        t0 = time.perf_counter()
        p, dev = self.params, self.device
        packets = [build_packet(f, cr=p.cr, device="cpu") for f in frames]
        width = max(len(x) for x in packets)
        padded = np.zeros((len(packets), width), np.int32)
        for r, x in enumerate(packets):
            padded[r, : len(x)] = x
        tx = modem.modulate(p, torch.from_numpy(padded), include_preamble=False, device=dev)
        lengths = [p.n_payload_symbols(len(x)) * p.samples_per_symbol for x in packets]
        noise = noise_rows(threefry.fold_in(self.noise_key, self.round), lengths, tx.shape[-1],
                           dev)
        snr = torch.tensor(snrs, dtype=REAL_DTYPE, device=dev)[:, None]
        rx = awgn(tx, snr, noise=noise)
        got = modem.demodulate(p, rx).payload.to(torch.uint8).cpu().numpy()
        received = []
        for frame, row, snr_db in zip(frames, got, snrs):
            payload, crc_ok = parse_packet(row, device="cpu")
            if crc_ok is None:
                outcome = "header"
            elif not crc_ok:
                outcome = "lora_crc"
            else:
                outcome = "ok" if payload == frame else "miscorrected"
            received.append(payload if crc_ok else b"")
            self.deliveries.append({"round": self.round, "snr_db": snr_db, "outcome": outcome,
                                    "bytes": payload})
        self.air.append({"round": self.round, "frames": frames, "snrs": snrs,
                         "rows": len(frames), "samples": int(tx.numel()),
                         "seconds": time.perf_counter() - t0})
        return received


def inboxes(sim: MeshSimulation) -> dict:
    """Every node's inbox as (src, dst, packet_id, hop_limit, payload)."""
    return {nid: [(p.src, p.dst, p.packet_id, p.hop_limit, p.payload) for p in n.inbox]
            for nid, n in sim.nodes.items()}


def run_mesh(scene: MeshScene, device=DEFAULT_DEVICE) -> dict:
    """Build `scene` on a `LoRaMeshSimulation` on `device` and run it.
    Returns the simulation, its traffic, the moved count of each round,
    status, inboxes, deliveries and the PHY's counts and seconds."""
    dev = resolve_device(device)
    sim = LoRaMeshSimulation(SEED, scene.lora_params(), dev, SEED)
    traffic = build_simulation(scene, sim)
    t0 = time.perf_counter()
    moved = []
    for _ in range(MAX_ROUNDS):
        moved.append(sim.step())
        if moved[-1] == 0:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    samples = sum(a["samples"] for a in sim.air)
    return {"sim": sim, "traffic": traffic, "moved": moved, "rounds": sim.round,
            "status": sim.status(), "inboxes": inboxes(sim), "deliveries": sim.deliveries,
            "frames": len(sim.deliveries), "samples": samples, "iq_gb": samples * 8 / 1e9,
            "seconds": seconds, "air_seconds": sum(a["seconds"] for a in sim.air),
            "device": str(dev)}


def run_without_phy(scene: MeshScene) -> dict:
    """The same scene and traffic on the PHY-less `MeshSimulation`."""
    sim = MeshSimulation(SEED)
    traffic = build_simulation(scene, sim)
    moved = []
    for _ in range(MAX_ROUNDS):
        moved.append(sim.step())
        if moved[-1] == 0:
            break
    return {"sim": sim, "traffic": traffic, "moved": moved, "rounds": sim.round,
            "status": sim.status(), "inboxes": inboxes(sim)}


def snr_buckets(deliveries: list[dict], width_db: float = 2.0) -> dict:
    """Deliveries and failures by link SNR in `width_db` buckets, keyed by
    each bucket's lower edge."""
    out: dict[float, dict] = {}
    for d in deliveries:
        edge = float(np.floor(d["snr_db"] / width_db) * width_db)
        b = out.setdefault(edge, {"deliveries": 0, "failed": 0})
        b["deliveries"] += 1
        b["failed"] += d["outcome"] != "ok"
    return dict(sorted(out.items()))


def payload_bars(run: dict) -> dict:
    """The payload bars on a run (module docstring): texts, traceroute,
    ACKs. Returns {"texts_arrived", "texts_right", "trace_in_order",
    "trace_relays", "acks_held", "acks_wanted"}."""
    sim = run["sim"]
    codec = MeshtasticCodec(CHANNEL)
    arrived = right = 0
    acks_wanted = acks_held = 0
    trace_ok, relays = False, None
    adjacency = {(a, b) for a, b in sim.links}
    for t in run["traffic"]:
        inbox = sim.nodes[t["dst"]].inbox if t["dst"] != BROADCAST else []
        got = [p for p in inbox if p.src == t["src"] and p.packet_id == t["packet_id"]]
        if t["kind"] == "text" and got:
            arrived += 1
            hdr, payload = codec.decode(got[0].payload)
            right += (Data.decode(payload).decode_text() == t["text"]
                      and hdr.from_ == t["src"] and hdr.to == t["dst"])
            if t["want_ack"]:
                acks_wanted += 1
                ack = ACK_PREFIX + struct.pack("<I", t["packet_id"])
                acks_held += any(p.payload == ack and p.src == t["dst"]
                                 for p in sim.nodes[t["src"]].inbox)
        if t["kind"] == "traceroute" and got:
            pkt = got[0]
            relays = np.frombuffer(pkt.payload[len(TRACE_PREFIX):], np.uint32).tolist()
            path = [t["src"], *relays, t["dst"]]
            trace_ok = (pkt.payload.startswith(TRACE_PREFIX)
                        and tuple(relays) == tuple(pkt.relayed_by)
                        and all((a, b) in adjacency for a, b in zip(path, path[1:])))
    return {"texts_arrived": arrived, "texts_right": right, "trace_in_order": bool(trace_ok),
            "trace_relays": relays, "acks_held": acks_held, "acks_wanted": acks_wanted}


def outcome(run: dict) -> dict:
    """What card = CPU compares: every delivery's outcome and bytes, every
    node's status, every inbox, the rounds and the moved counts."""
    return {"deliveries": [(d["round"], d["snr_db"], d["outcome"], d["bytes"])
                           for d in run["deliveries"]],
            "status": run["status"], "inboxes": run["inboxes"], "rounds": run["rounds"],
            "moved": run["moved"]}


def compare_runs(got: dict, want: dict) -> dict:
    """Card = CPU on two runs of one scene, given as their `outcome`s: each
    key equal. Returns {key: bool}, "equal" and the first differing
    deliveries."""
    same = {k: got[k] == want[k] for k in want}
    differing = [i for i, (x, y) in enumerate(zip(got["deliveries"], want["deliveries"]))
                 if x != y]
    return {**same, "equal": all(same.values()), "first_differing_deliveries": differing[:10]}


def mesh_lora_gate(device=DEFAULT_DEVICE) -> dict:
    """The LongFast mesh on `device` (module docstring): the gate's run, its
    bars and report, and the +10 dB run against the PHY-less simulation."""
    run = run_mesh(GATE, device)
    strong = [d for d in run["deliveries"] if d["snr_db"] >= STRONG_DB]
    payloads = payload_bars(run)
    high = run_mesh(dataclasses.replace(GATE, link_snr_db=HIGH_SNR_DB), device)
    plain = run_without_phy(dataclasses.replace(GATE, link_snr_db=HIGH_SNR_DB))
    high_payloads = payload_bars(high)
    bars = {
        "strong_links_deliver": all(d["outcome"] == "ok" for d in strong),
        "texts_right": payloads["texts_right"] == payloads["texts_arrived"] > 0,
        "trace_in_order": payloads["trace_relays"] is None or payloads["trace_in_order"],
        "acks_held": payloads["acks_held"] == payloads["acks_wanted"],
        "high_snr_equals_no_phy": (high["status"] == plain["status"]
                                   and high["inboxes"] == plain["inboxes"]),
        "high_snr_payloads": (high_payloads["texts_right"] == high_payloads["texts_arrived"]
                              == GATE.texts and high_payloads["trace_in_order"]
                              and high_payloads["acks_held"] == high_payloads["acks_wanted"]
                              == GATE.acks),
    }
    bars = {k: bool(v) for k, v in bars.items()}
    failures = {}
    for d in run["deliveries"]:
        failures[d["outcome"]] = failures.get(d["outcome"], 0) + 1
    return {"ok": all(bars.values()), "bars": bars, "run": run, "high": high,
            "payloads": payloads, "high_payloads": high_payloads, "buckets": snr_buckets(run["deliveries"]),
            "outcomes": failures, "strong_frames": len(strong)}
