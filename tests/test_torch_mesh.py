"""The LoRa mesh's port (`mesh_proto`, `mesh`, `mesh_meshtastic`,
`mesh_gates`) against the JAX package's modules.

The reference's own tests (`tests/test_mesh_proto.py`,
`tests/test_mesh_meshtastic.py` and the mesh part of
`tests/test_mesh_registry.py`) run with their module swapped for the
port's; the Meshtastic tests that encrypt need ``cryptography`` and skip
without it. Wire bytes are held equal to the reference's for every message
type; the port's `MeshSimulation` equals the reference's on the same seed,
links and traffic; the gate runs at a small size (a 2 × 3 grid, the SF7
``ShortFast`` preset) on the CPU, at +10 dB equal to the reference's
simulation with no PHY.

Where a test runs the reference's `MeshSimulation`, its CRC-16 is the
port's host CRC (`_host_crc`): the reference's eager JAX CRC costs ~50 ms a
packet, and a small flood is hundreds of packets. The CRCs themselves are
held equal to the reference's own on every frame length the gate sends
(`test_crc16_equals_the_references`) and on whole packets
(`test_wire_frames_equal_the_references`).
"""

from __future__ import annotations

import dataclasses
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu import mesh as ref_mesh
from r4w_tpu import mesh_meshtastic as ref_mm
from r4w_tpu import mesh_proto as ref_proto
from r4w_tpu_torch import mesh, mesh_gates, mesh_meshtastic, mesh_proto
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.fec.crc import crc_compute

NOISE_TOL = 3e-7   # threefry normals against JAX's (channel.threefry)

PROTO_TESTS = [
    "test_data_text_known_bytes", "test_default_fields_omitted",
    "test_data_roundtrip_all_fields", "test_fixed32_wire_type",
    "test_position_coords_and_sint32", "test_negative_int32_varint",
    "test_sfixed32_negative_latitude", "test_user_roundtrip_and_truncation",
    "test_unknown_fields_skipped", "test_classify_payload_falls_back_to_text",
    "test_portnum_values_match_reference", "test_end_to_end_encrypted_text",
    "test_end_to_end_position_and_telemetry",
]
PROTO_NAMES = ["AirQualityMetrics", "Data", "DeviceMetrics", "EnvironmentMetrics",
               "LocalStats", "PortNum", "Position", "PowerMetrics", "Telemetry", "User",
               "classify_payload"]
# Meshtastic reference tests that need no cipher (the rest encrypt on the
# default channel key and need `cryptography`)
CLEAR_TESTS = [
    "TestWireHeader.test_byte_layout_known_answer", "TestWireHeader.test_roundtrip",
    "TestWireHeader.test_flags_bit_ranges", "TestChannelCrypto.test_default_psk_value",
    "TestChannelCrypto.test_psk_expansion", "TestChannelCrypto.test_channel_hash_xor_fold",
    "TestChannelCrypto.test_nonce_layout", "TestCodec.test_unencrypted_channel",
    "TestNextHopRouting.test_routing_table_eviction_and_prune",
    "TestNextHopRouting.test_modem_presets",
]
CIPHER_TESTS = [
    "TestChannelCrypto.test_ctr_roundtrip_and_independence",
    "TestChannelCrypto.test_ctr_known_answer_independent_construction",
    "TestCodec.test_byte_identical_reference_frame",
    "TestCodec.test_decode_rejects_wrong_channel",
    "TestNextHopRouting.test_route_learning_from_broadcast",
    "TestNextHopRouting.test_direct_packet_uses_next_hop_not_flood",
    "TestNextHopRouting.test_unrouted_direct_floods",
    "TestNextHopRouting.test_duplicate_suppression",
    "TestNextHopRouting.test_hop_limit_exhaustion",
]
MESH_TESTS = [
    "test_packet_wire_roundtrip_and_crc", "test_flood_routing_multi_hop_line_topology",
    "test_ack_and_neighbor_learning", "test_hop_limit_prevents_delivery",
    "test_traceroute_accumulates_relays", "test_store_and_forward",
    "test_lossy_link_statistics",
]
# the reference's simulation against the port's: a small grid, +10 dB links
SMALL = mesh_gates.MeshScene(rows=2, cols=3, preset="ShortFast", texts=3, acks=2,
                             link_snr_db=10.0)


def _host_crc(data, name):
    return crc_compute(data, name, device="cpu")


def _call(module, name: str):
    owner, _, method = name.partition(".")
    fn = getattr(getattr(module, owner)(), method) if method else getattr(module, owner)
    fn()


def _port_ports(monkeypatch):
    """Point in-body imports of the reference's mesh modules at the port's."""
    monkeypatch.setitem(sys.modules, "r4w_tpu.mesh_proto", mesh_proto)
    monkeypatch.setitem(sys.modules, "r4w_tpu.mesh_meshtastic", mesh_meshtastic)


def test_proto_and_meshtastic_are_the_references_copies():
    """mesh_proto is a byte copy; mesh_meshtastic differs only in its
    docstring and its imports of mesh_proto."""
    with open(ref_proto.__file__, "rb") as a, open(mesh_proto.__file__, "rb") as b:
        assert a.read() == b.read()
    with open(ref_mm.__file__) as a, open(mesh_meshtastic.__file__) as b:
        ref, port = a.read(), b.read()
    code = lambda s: s[s.index('"""', 3) + 3:].replace("r4w_tpu_torch.", "r4w_tpu.")  # noqa: E731
    assert code(ref) == code(port)


@pytest.mark.parametrize("name", PROTO_TESTS)
def test_reference_proto_tests_on_the_port(monkeypatch, name):
    if name == "test_end_to_end_encrypted_text":
        pytest.importorskip("cryptography")
    ref = importlib.import_module("test_mesh_proto")
    for attr in PROTO_NAMES:
        monkeypatch.setattr(ref, attr, getattr(mesh_proto, attr))
    _port_ports(monkeypatch)
    _call(ref, name)


@pytest.mark.parametrize("index", range(5))
def test_reference_telemetry_variants_on_the_port(monkeypatch, index):
    ref = importlib.import_module("test_mesh_proto")
    variant = ref.test_telemetry_oneof_roundtrip.pytestmark[0].args[1][index]
    monkeypatch.setattr(ref, "Telemetry", mesh_proto.Telemetry)
    ref.test_telemetry_oneof_roundtrip(
        getattr(mesh_proto, type(variant).__name__)(**dataclasses.asdict(variant)))


@pytest.mark.parametrize("name", CLEAR_TESTS + CIPHER_TESTS)
def test_reference_meshtastic_tests_on_the_port(monkeypatch, name):
    if name in CIPHER_TESTS:
        pytest.importorskip("cryptography")
    ref = importlib.import_module("test_mesh_meshtastic")
    monkeypatch.setattr(ref, "mm", mesh_meshtastic)
    _call(ref, name)


@pytest.mark.parametrize("name", MESH_TESTS)
def test_reference_mesh_tests_on_the_port(monkeypatch, name):
    ref = importlib.import_module("test_mesh_registry")
    monkeypatch.setattr(ref, "mesh", mesh)
    _call(ref, name)


def _filled(cls, rng):
    """An instance of a message class with every field set from `rng`."""
    values = {}
    for f in dataclasses.fields(cls):
        kind = next((e[2] for e in cls._schema if e[1] == f.name), None)
        if kind in ("int32", "sfixed32", "sint32"):
            values[f.name] = int(rng.integers(-2**31, 2**31))
        elif kind in ("uint32", "fixed32", "enum"):
            values[f.name] = int(rng.integers(1, 2**31))
        elif kind == "float":
            values[f.name] = float(np.float32(rng.standard_normal() * 100))
        elif kind == "bool":
            values[f.name] = True
        elif kind == "bytes":
            values[f.name] = bytes(rng.integers(0, 256, int(rng.integers(1, 20)), np.uint8))
        elif kind == "string":
            values[f.name] = "".join(chr(int(c)) for c in rng.integers(32, 127, 9))
    return values


@pytest.mark.parametrize("name", ["Position", "User", "DeviceMetrics", "EnvironmentMetrics",
                                  "PowerMetrics", "AirQualityMetrics", "LocalStats", "Data",
                                  "Telemetry"])
def test_message_bytes_equal_the_references(name):
    rng = np.random.default_rng(21)
    if name == "Telemetry":
        fields = _filled(ref_proto.EnvironmentMetrics, rng)
        ref_msg = ref_proto.Telemetry(time=123456, variant=ref_proto.EnvironmentMetrics(**fields))
        port_msg = mesh_proto.Telemetry(time=123456,
                                        variant=mesh_proto.EnvironmentMetrics(**fields))
    else:
        fields = _filled(getattr(ref_proto, name), rng)
        ref_msg = getattr(ref_proto, name)(**fields)
        port_msg = getattr(mesh_proto, name)(**fields)
    raw = port_msg.encode()
    assert raw == ref_msg.encode() and len(raw) > 0
    assert getattr(mesh_proto, name).decode(raw) == port_msg


def test_wire_frames_equal_the_references():
    """The gate's traffic frames, the mesh packet bytes and the routing
    decisions of the unencrypted channel equal the reference's."""
    chan_ref, chan_port = ref_mm.ChannelKey("LongFast", b"\x00"), mesh_gates.CHANNEL
    a_ref, a_port = ref_mm.MeshtasticNode(5, chan_ref), mesh_meshtastic.MeshtasticNode(5, chan_port)
    f_ref = ref_mm.send_text(a_ref, "mesh over LoRa", to=9)
    f_port = mesh_meshtastic.send_text(a_port, "mesh over LoRa", to=9)
    assert f_ref == f_port
    p_ref = ref_mesh.MeshPacket(src=5, dst=9, packet_id=77, want_ack=True, payload=f_ref)
    p_port = mesh.MeshPacket(src=5, dst=9, packet_id=77, want_ack=True, payload=f_port)
    assert p_ref.encode() == p_port.encode()
    assert (dataclasses.astuple(mesh.MeshPacket.decode(p_ref.encode()))
            == dataclasses.astuple(ref_mesh.MeshPacket.decode(p_port.encode())))
    b_ref, b_port = ref_mm.MeshtasticNode(9, chan_ref), mesh_meshtastic.MeshtasticNode(9, chan_port)
    assert b_ref.on_receive(f_ref, 5) == b_port.on_receive(f_port, 5)


@pytest.mark.parametrize("n", [17, 36, 68, 101])
def test_crc16_equals_the_references(n):
    body = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    want = int(ref_mesh.crc_compute(np.frombuffer(body, np.uint8).astype(np.int32),
                                    "crc16-ccitt"))
    assert mesh._crc16(body) == want


@pytest.fixture(scope="module")
def reference_small():
    """The reference's PHY-less simulation of SMALL (on the host CRC)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_mesh, "crc_compute", _host_crc)
        sim = ref_mesh.MeshSimulation(mesh_gates.SEED)
        traffic = mesh_gates.build_simulation(SMALL, sim)
        moved = []
        for _ in range(mesh_gates.MAX_ROUNDS):
            moved.append(sim.step())
            if moved[-1] == 0:
                break
    return {"sim": sim, "traffic": traffic, "moved": moved, "status": sim.status(),
            "inboxes": mesh_gates.inboxes(sim)}


def test_simulation_status_equals_the_references(reference_small):
    got = mesh_gates.run_without_phy(SMALL)
    assert got["moved"] == reference_small["moved"]
    assert got["status"] == reference_small["status"]
    assert got["inboxes"] == reference_small["inboxes"]


def test_lossy_simulation_draws_the_references_rng(monkeypatch):
    """Lossy links consume the rng per delivery as the reference does."""
    monkeypatch.setattr(ref_mesh, "crc_compute", _host_crc)
    sims = []
    for module in (ref_mesh, mesh):
        sim = module.MeshSimulation(seed=7)
        for nid in range(5):
            sim.add_node(nid)
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 4), (0, 2), (1, 3)):
            sim.connect(a, b, snr_db=float(a - b), loss=0.35)
        for i in range(6):
            sim.nodes[i % 5].send((i + 2) % 5, bytes([i]) * 3, want_ack=i % 2 == 0)
        sim.run()
        sims.append(sim)
    assert sims[0].status() == sims[1].status()
    assert mesh_gates.inboxes(sims[0]) == mesh_gates.inboxes(sims[1])


def test_small_gate_at_10_db_equals_the_reference_without_phy(reference_small):
    """The LoRa PHY loses nothing at +10 dB: the small gate's final state is
    the reference's PHY-less simulation's."""
    got = mesh_gates.run_mesh(SMALL, "cpu")
    assert got["status"] == reference_small["status"]
    assert got["inboxes"] == reference_small["inboxes"]
    assert got["moved"] == reference_small["moved"]
    assert all(d["outcome"] == "ok" for d in got["deliveries"])
    assert got["frames"] == sum(got["moved"])
    bars = mesh_gates.payload_bars(got)
    assert bars["texts_right"] == bars["texts_arrived"] == SMALL.texts
    assert bars["acks_held"] == bars["acks_wanted"] == SMALL.acks
    assert bars["trace_in_order"]


def test_small_gate_at_drawn_snrs():
    """At SNRs drawn around SF7's floor, frames fail on the weak links only,
    and the run is reproducible (the same seed, the same outcomes)."""
    scene = dataclasses.replace(SMALL, link_snr_db=None, axial_snr_db=(-9.0, 3.0),
                                diagonal_snr_db=(-13.0, -3.0))
    one, two = mesh_gates.run_mesh(scene, "cpu"), mesh_gates.run_mesh(scene, "cpu")
    assert mesh_gates.compare_runs(mesh_gates.outcome(one), mesh_gates.outcome(two))["equal"]
    outcomes = {d["outcome"] for d in one["deliveries"]}
    assert "ok" in outcomes and outcomes - {"ok"}
    assert all(d["outcome"] == "ok" for d in one["deliveries"] if d["snr_db"] >= -3.0)
    bars = mesh_gates.payload_bars(one)
    assert bars["texts_right"] == bars["texts_arrived"]
    buckets = mesh_gates.snr_buckets(one["deliveries"])
    assert sum(b["deliveries"] for b in buckets.values()) == one["frames"]


@pytest.mark.parametrize("pass_samples", [mesh_gates.NOISE_PASS, 400])
def test_noise_rows_are_jax_draws(monkeypatch, pass_samples):
    """Row r of the gate's noise is jax.random.normal over fold_in(key, r)'s
    two splits, zeros after the row's length, however many rows a pass
    draws together."""
    monkeypatch.setattr(mesh_gates, "NOISE_PASS", pass_samples)
    key = threefry.fold_in(threefry.key(21), 3)
    lengths = [300, 128, 0, 257]
    got = mesh_gates.noise_rows(key, lengths, 300, torch.device("cpu")).numpy()
    jkey = jax.random.fold_in(jax.random.key(21), 3)
    for r, m in enumerate(lengths):
        re_k, im_k = jax.random.split(jax.random.fold_in(jkey, r))
        want = (np.asarray(jax.random.normal(re_k, (m,), jnp.float32))
                + 1j * np.asarray(jax.random.normal(im_k, (m,), jnp.float32)))
        np.testing.assert_allclose(got[r, :m], want, atol=NOISE_TOL, rtol=0)
        assert not np.any(got[r, m:])


def test_gate_scene_links_and_traffic():
    """The gate's grid: 24 axial links on [-20, -6] dB, 18 diagonal on
    [-24, -14] dB; nodes 0-7 send texts of 12-64 characters, node 0 a
    position and a telemetry, node 15 a traceroute; frames fit 100 SF11
    symbols."""
    sim = mesh.MeshSimulation(mesh_gates.SEED)
    traffic = mesh_gates.build_simulation(mesh_gates.GATE, sim)
    links = mesh_gates.scene_links(mesh_gates.GATE, np.random.default_rng(21))
    axial, diagonal = links[:24], links[24:]
    assert len(diagonal) == 18 and len(sim.links) == 2 * 42
    assert all(-20 <= s <= -6 for *_, s in axial) and all(-24 <= s <= -14 for *_, s in diagonal)
    texts = [t for t in traffic if t["kind"] == "text"]
    assert [t["src"] for t in texts] == list(range(8))
    assert all(12 <= len(t["text"]) <= 64 and t["dst"] != t["src"] for t in texts)
    assert [t["want_ack"] for t in texts] == [True] * 4 + [False] * 4
    assert [t["kind"] for t in traffic[8:]] == ["position", "telemetry", "traceroute"]
    params = mesh_gates.GATE.lora_params()
    assert (params.sf, params.bw_hz, params.cr) == (11, 250_000, 1)
    longest = max(len(mesh.MeshPacket(0, 0, 0, payload=t["frame"]).encode()) for t in traffic)
    assert params.n_payload_symbols(longest + 5) <= 100
