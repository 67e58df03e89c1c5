"""The port's native iqcore runtime and host real-time primitives against
``r4w_tpu.native`` and ``r4w_tpu.rt``.

The conversions are held bit for bit against the reference's library on
the same numpy inputs, and the plain (numpy) versions against the native
ones; the reference's own tests of ``tests/test_native.py`` and
``tests/test_rt.py`` run against the port's modules. Sockets bind port 0
on 127.0.0.1 and every wait on one has a deadline of 3 s.
"""

import socket
import struct
import time
from pathlib import Path

import numpy as np
import pytest

from r4w_tpu import native as ref_native
from r4w_tpu_torch import native, rt
from r4w_tpu_torch.net import encode_packet
from torch_port_proxy import run_reference_test

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 3.0
PORT_MODULES = {"r4w_tpu.native": "r4w_tpu_torch.native", "r4w_tpu.net": "r4w_tpu_torch.net"}


def _wait(predicate) -> bool:
    end = time.time() + DEADLINE_S
    while time.time() < end and not predicate():
        time.sleep(0.005)
    return predicate()


def test_native_builds_into_build_dir():
    assert native.native_available(), native.build_error()
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "build" / "r4w_tpu_torch" / "native"
    assert not list((REPO / "r4w_tpu_torch" / "native").glob("*.so"))


@pytest.mark.parametrize("name", ["iqcore.cpp", "r4w_plugin.h", "example_plugin.cpp"])
def test_sources_are_the_reference_copies(name):
    assert ((REPO / "r4w_tpu_torch" / "native" / name).read_bytes()
            == (REPO / "r4w_tpu" / "native" / name).read_bytes())


def _iq_floats(n=4099, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    x[:8] = [0.0, 1.0, -1.0, 0.5 / 32767, -0.5 / 32767, 1.5 / 127, 2.0, -2.0]  # ties, clips
    return x


@pytest.mark.parametrize("name,arg", [
    ("f32_to_i16", lambda: _iq_floats()),
    ("i16_to_f32", lambda: np.random.default_rng(1).integers(-32768, 32768, 999).astype(np.int16)),
])
def test_conversions_equal_reference(name, arg):
    x = arg()
    assert ref_native.native_available(), ref_native.build_error()
    np.testing.assert_array_equal(getattr(native, name)(x), getattr(ref_native, name)(x))


def test_interleave_equals_reference():
    rng = np.random.default_rng(2)
    re, im = rng.standard_normal((2, 777)).astype(np.float32)
    inter = native.interleave(re, im)
    np.testing.assert_array_equal(inter, ref_native.interleave(re, im))
    for got, want in zip(native.deinterleave(inter), ref_native.deinterleave(inter)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,arg", [
    ("f32_to_i8", lambda: _iq_floats(seed=3)),
    ("i8_to_f32", lambda: np.arange(-128, 128).astype(np.int8)),
    ("f32_to_u8", lambda: _iq_floats(seed=4)),
    ("u8_to_f32", lambda: np.arange(256).astype(np.uint8)),
    ("interleave", lambda: (_iq_floats(seed=5), _iq_floats(seed=6))),
])
def test_plain_versions_equal_native(monkeypatch, name, arg):
    """The numpy plain versions round as the library does (float32 product,
    half away from zero) for the i8 and u8 formats."""
    x = arg()
    args = x if isinstance(x, tuple) else (x,)
    want = getattr(native, name)(*args)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(getattr(native, name)(*args), want)


def test_plain_i16_is_the_reference_fallback(monkeypatch):
    x = _iq_floats(seed=7)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    np.testing.assert_array_equal(native.f32_to_i16(x), ref_native.f32_to_i16(x))
    rb = native.NativeRingBuffer(64)
    assert rb.write(np.ones(100, np.float32)) == 64 and rb.readable == 64


@pytest.mark.parametrize("name", [
    "test_native_builds", "test_i16_conversion_accuracy", "test_interleave_roundtrip",
    "test_ring_buffer_spsc_semantics", "test_ring_buffer_backpressure", "test_ring_complex_api",
    "test_native_udp_receiver_roundtrip", "test_native_udp_receiver_seq_gap_accounting",
    "test_native_udp_receiver_bulk_throughput"])
def test_reference_native_cases(monkeypatch, name):
    """tests/test_native.py's own cases on the port's native and net."""
    run_reference_test(monkeypatch, "test_native", name, modules=PORT_MODULES,
                       native="r4w_tpu_torch.native")


def test_udp_read_carries_a_split_pair():
    """A ring read that ends inside an I/Q pair carries the dangling I to
    the next read, so the stream never misaligns."""
    with native.NativeUdpReceiver(port=0) as rx:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            first = np.array([1.0, 2.0, 3.0], np.float32)  # one pair and a dangling I
            sock.sendto(struct.pack("<I", 0) + first.tobytes(), ("127.0.0.1", rx.port))
            assert _wait(lambda: rx.stats["packets"] == 1)
            got = rx.read(4)
            np.testing.assert_array_equal(got, np.array([1 + 2j], np.complex64))
            assert rx.read(4).size == 0  # the carried float alone is no sample
            sock.sendto(struct.pack("<I", 1) + np.float32(4.0).tobytes() + encode_packet(
                0, np.array([5 + 6j], np.complex64), has_header=False), ("127.0.0.1", rx.port))
            assert _wait(lambda: rx.stats["packets"] == 2)
            np.testing.assert_array_equal(rx.read(4), np.array([3 + 4j, 5 + 6j], np.complex64))
            assert rx.stats["seq_gaps"] == 0
        finally:
            sock.close()


@pytest.mark.parametrize("name", [
    "test_buffer_pool_acquire_release", "test_buffer_pool_blocking_handoff",
    "test_latency_histogram_percentiles", "test_processing_timer", "test_rt_stats_throughput",
    "test_spawn_rt_thread_runs", "test_native_ring_reexport", "test_allocation_audit_detects"])
def test_reference_rt_cases(monkeypatch, name):
    """tests/test_rt.py's own cases on the port's rt."""
    run_reference_test(monkeypatch, "test_rt", name, rt="r4w_tpu_torch.rt")


def test_rt_reexports_the_ports_ring():
    assert rt.NativeRingBuffer is native.NativeRingBuffer
    h = rt.LatencyHistogram()
    for s in (1e-4, 2e-4, 1e-2):
        h.record(s)
    assert h.summary()["count"] == 3 and h.p50 < h.p999
