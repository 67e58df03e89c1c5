"""The port's UDP transport, agent control plane and benchmark harness
against ``r4w_tpu.net``, ``r4w_tpu.agent`` and ``r4w_tpu.benchmark``.

The wire bytes equal the reference's on the same samples; the reference's
cases of ``tests/test_infra.py`` (net, agent, benchmark) run on the port
on the CPU, and so does the remote-lab gate at a short run. Sockets bind
port 0 on 127.0.0.1 and every wait on one has a deadline of 3 s.
"""

import threading
import time

import numpy as np
import pytest
import torch

from r4w_tpu.net import decode_packet as ref_decode_packet
from r4w_tpu.net import encode_packet as ref_encode_packet
from r4w_tpu_torch import remote_gates
from r4w_tpu_torch.agent import AgentClient, AgentServer
from r4w_tpu_torch.benchmark import BenchmarkReceiver, WaveformRunner
from r4w_tpu_torch.net import UdpConfig, UdpSink, UdpSource, decode_packet, encode_packet
from r4w_tpu_torch.waveforms import create_waveform, list_waveforms

DEADLINE_S = 3.0


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("has_header", [True, False])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_wire_bytes_equal_reference(has_header, as_tensor):
    x = _iq(1001)
    arg = torch.from_numpy(x) if as_tensor else x
    raw = encode_packet(0x1_0000_0007, arg, has_header)  # the sequence wraps at 32 bits
    assert raw == ref_encode_packet(0x1_0000_0007, x, has_header)
    seq, back = decode_packet(raw + b"\x01\x02\x03", has_header)
    ref_seq, ref_back = ref_decode_packet(raw + b"\x01\x02\x03", has_header)
    assert seq == ref_seq and np.array_equal(back, ref_back) and np.array_equal(back, x)


def test_udp_packet_wire_format():
    """tests/test_infra.py's case."""
    x = (np.arange(4) + 1j * np.arange(4)).astype(np.complex64)
    raw = encode_packet(7, x)
    assert raw[:4] == (7).to_bytes(4, "little")
    seq, back = decode_packet(raw)
    assert seq == 7 and np.array_equal(back, x)
    assert decode_packet(b"\x00\x01") is None


def test_udp_loopback_with_drop_accounting():
    """tests/test_infra.py's case, bound to 127.0.0.1; a tensor on the sender."""
    src = UdpSource(UdpConfig(host="127.0.0.1", port=0, timeout_s=0.2))
    sink = UdpSink("127.0.0.1", src.port)
    x = np.exp(1j * 0.1 * np.arange(500)).astype(np.complex64)
    sink.send(torch.from_numpy(x))
    got = src.recv_batch()
    assert np.allclose(got, x, atol=1e-6)
    sink.seq += 3  # a drop: skip sequence numbers
    sink.send(x[:10])
    src.recv_batch()
    assert src.packets_dropped == 3
    assert sink.packets_sent == 2 and sink.samples_sent == 510 and src.samples_received == 510
    sink.close()
    src.close()


def test_sink_splits_into_mtu_packets():
    src = UdpSource(UdpConfig(host="127.0.0.1", port=0, timeout_s=0.5))
    sink = UdpSink("127.0.0.1", src.port)
    x = _iq(20_000, seed=1)
    assert sink.send(x) == 3  # (65000 - 4) // 8 = 8124 samples a packet
    got = src.recv_batch()
    assert np.array_equal(got, x) and src.packets_received == 3
    sink.close()
    src.close()


@pytest.fixture
def agent():
    server = AgentServer(port=0, device="cpu")
    thread = server.serve_in_thread()
    client = AgentClient(port=server.port, timeout_s=DEADLINE_S)
    yield server, client
    client.shutdown()
    client.close()
    thread.join(DEADLINE_S)
    assert not thread.is_alive()


def test_agent_server_client_roundtrip(agent):
    """tests/test_infra.py's case on the CPU: agent TX -> local UDP -> demod."""
    server, client = agent
    assert client.ping()["response"] == "pong"
    st = client.status()
    assert st["response"] == "status" and not st["data"]["tx_active"]
    assert client.call("list_waveforms")["data"] == list_waveforms()
    rx = UdpSource(UdpConfig(host="127.0.0.1", port=0, timeout_s=0.3))
    r = client.start_tx(f"127.0.0.1:{rx.port}", waveform="QPSK", message="agent!")
    assert r["response"] == "ok"
    assert server.join_tx(DEADLINE_S)
    samples = rx.recv_batch()
    res = create_waveform("QPSK", 125_000.0, "cpu").demodulate(samples)
    assert bytes(res.bits[:6].numpy().astype(np.uint8)) == b"agent!"
    assert client.call("nonsense") == {"response": "error", "message": "unknown command nonsense"}
    assert client.call("start_tx", waveform="NOPE")["message"] == "unknown waveform"
    assert client.call("metrics")["response"] == "metrics"
    rx.close()


def test_agent_rx_commands(agent):
    _, client = agent
    r = client.call("start_rx", port=0)
    assert r["response"] == "ok" and client.status()["data"]["rx_active"]
    assert client.call("stop_rx") == {"response": "ok",
                                      "data": {"packets": 0, "dropped": 0, "samples": 0}}


def test_agent_modulates_on_its_device_and_repeats(agent):
    server, client = agent
    src = UdpSource(UdpConfig(host="127.0.0.1", port=0, timeout_s=0.5))
    client.start_tx(f"127.0.0.1:{src.port}", waveform="BPSK", message="hi", repeat=True, pps=200)
    want = create_waveform("BPSK", 125_000.0, "cpu").modulate(b"hi").numpy()
    first = src.recv()
    assert np.array_equal(first, want)  # the burst in one packet, bit for bit
    assert client.status()["data"]["tx_active"]
    assert client.stop_tx()["response"] == "ok" and server.join_tx(DEADLINE_S)
    assert server.tx_sent["packets"] >= 1
    src.close()


def test_benchmark_receiver_end_to_end():
    """tests/test_infra.py's case on the CPU, on the native receiver."""
    recv = BenchmarkReceiver(port=0, waveform_name="BPSK", device="cpu")
    assert recv.native is not None
    burst = create_waveform("BPSK", 125_000.0, "cpu").modulate(b"bench").numpy()

    def feed():
        sink = UdpSink("127.0.0.1", recv.port)
        for _ in range(5):
            sink.send(burst)
            time.sleep(0.05)
        sink.close()

    t = threading.Thread(target=feed)
    t.start()
    metrics = recv.run(duration_s=1.0, print_fn=lambda _: None)
    t.join(DEADLINE_S)
    assert metrics.samples_processed >= len(burst) * 4
    assert metrics.throughput_msps() > 0
    lat = metrics.latency_stats()
    assert lat["p99"] >= lat["avg"] > 0
    assert recv.runner.histogram.count == metrics.batches
    assert metrics.packets_dropped == 0
    recv.close()


def test_benchmark_python_source_path():
    recv = BenchmarkReceiver(port=0, waveform_name="BPSK", native=False, device="cpu")
    assert recv.native is None and recv.source is not None
    burst = create_waveform("BPSK", 125_000.0, "cpu").modulate(b"py").numpy()
    sink = UdpSink("127.0.0.1", recv.port)
    sink.send(burst)
    bits = recv.runner.process(recv._recv_batch())
    assert bytes(bits[:2].astype(np.uint8)) == b"py"
    assert "throughput" in recv.runner.metrics.report()
    sink.close()
    recv.close()


def test_runner_returns_host_bits_of_a_tensor_batch():
    runner = WaveformRunner("LoRa-SF7", device="cpu")
    tx = create_waveform("LoRa-SF7", 125_000.0, "cpu").modulate(b"lora")
    bits = runner.process(tx)
    assert isinstance(bits, np.ndarray) and bytes(bits[:4].astype(np.uint8)) == b"lora"
    assert runner.metrics.batches == runner.histogram.count == 1
    with pytest.raises(ValueError, match="unknown waveform"):
        WaveformRunner("NOPE", device="cpu")


def test_remote_lab_gate_on_the_cpu(monkeypatch):
    monkeypatch.setattr(remote_gates, "RUN_SECONDS", 0.3)  # phase 2 shortened on the CPU
    gate = remote_gates.remote_lab_gate("cpu")
    assert gate["ok"], gate["bars"]
    assert gate["packet"]["samples"] == remote_gates.BURST_SAMPLES
    assert gate["run"]["batches"] > 0 and gate["run"]["dechirp_launches"] == 0  # no card
    assert len(remote_gates.gate_payload()) == remote_gates.PAYLOAD_BYTES
