"""Stream and PDU plumbing against the JAX package's, paired with
tests/test_streams.py: the same inputs through both modules, tensors
(CPU) on the port's side; every result equal (these blocks only cut,
join and tag, so nothing rounds)."""

import numpy as np
import pytest
import torch

from r4w_tpu import streams as ref
from r4w_tpu_torch import streams as st
from r4w_tpu_torch.core import types


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got),
                                  np.asarray(want))


def test_pdu_filter_route_set():
    pdus = [st.Pdu(torch.arange(4), {"ch": 1}), st.Pdu(torch.arange(2), {"ch": 2}),
            st.Pdu(torch.arange(3), {"ch": 1})]
    assert len(st.pdu_filter(pdus, "ch", 1)) == 2
    assert len(st.pdu_filter(pdus, "missing")) == 0
    routed = st.pdu_route(pdus, "ch")
    assert sorted(routed) == [1, 2] and [len(routed[1]), len(routed[2])] == [2, 1]
    st.pdu_set(pdus, "crc", True)
    assert all(p.meta["crc"] for p in pdus)


def test_stream_pdu_roundtrip_equals_the_reference():
    x = np.arange(10.0)
    got, want = st.stream_to_pdus(torch.from_numpy(x), [0, 4, 7]), ref.stream_to_pdus(x, [0, 4, 7])
    assert [p.meta for p in got] == [p.meta for p in want]
    for g, w in zip(got, want):
        _eq(g.data, w.data)
    y, tags = st.pdus_to_stream(got)
    y_ref, tags_ref = ref.pdus_to_stream(want)
    _eq(y, y_ref)
    assert [(t.offset, t.key, t.value) for t in tags] == [
        (t.offset, t.key, t.value) for t in tags_ref] and [t.offset for t in tags] == [0, 4, 7]


@pytest.mark.parametrize("mask", [[0, 0, 1, 1, 1, 0, 1, 0], [1, 1, 0, 0, 1], [0, 0, 0],
                                  [1, 1, 1], [1, 0, 1, 0, 1, 1]])
def test_burst_tagger_equals_the_reference(mask):
    m = np.asarray(mask, bool)
    got = st.burst_tagger(torch.zeros(len(m)), torch.from_numpy(m))
    want = ref.burst_tagger(np.zeros(len(m)), m)
    assert [(t.offset, t.key, t.value) for t in got] == [(t.offset, t.key, t.value) for t in want]


def test_head_skip_delay_valve_selector():
    x = np.arange(8.0)
    t = torch.from_numpy(x)
    for name, args in (("head", (3,)), ("skiphead", (6,)), ("delay", (2,)), ("valve", (False,)),
                       ("valve", (True,))):
        _eq(getattr(st, name)(t, *args), getattr(ref, name)(x, *args))
    d = st.delay(t, 2)
    assert d.shape == (10,) and d.dtype == t.dtype
    assert st.selector([t, t + 1], 1)[0] == 1


@pytest.mark.parametrize("lengths", [[2, 3], [1, 4], [5, 5]])
def test_stream_mux_demux_equal_the_reference(lengths):
    a, b = np.arange(6.0), np.arange(100.0, 109.0)
    got = st.stream_mux([torch.from_numpy(a), torch.from_numpy(b)], lengths)
    _eq(got, ref.stream_mux([a, b], lengths))
    for g, w in zip(st.stream_demux(got, lengths), ref.stream_demux(np.asarray(got), lengths)):
        _eq(g, w)
    if lengths == [2, 3]:
        outs = st.stream_demux(got, lengths)
        _eq(outs[0], a)
        _eq(outs[1], b)


def test_vectors_roundtrip_and_map():
    x = np.arange(14.0)
    v = st.stream_to_vectors(torch.from_numpy(x), 4)
    _eq(v, ref.stream_to_vectors(x, 4))
    _eq(st.vectors_to_stream(v), ref.vectors_to_stream(np.asarray(v)))
    _eq(st.vector_map(v, lambda r: 2 * r), 2 * np.asarray(v))


def test_message_bus_and_strobe():
    bus = st.MessageBus()
    seen = []
    bus.subscribe("ctl", seen.append)
    bus.publish("ctl", {"cmd": "start"})
    st.message_strobe(bus, "ctl", "ping", 3)
    assert seen == [{"cmd": "start"}, "ping", "ping", "ping"]
    assert len(bus.history("ctl")) == 4 and len(bus.history()) == 4
    assert bus.history("other") == []


def test_wav_equals_the_reference(tmp_path):
    fs = 8000
    x = 0.5 * np.sin(2 * np.pi * 440 * np.arange(1600) / fs)
    p, q = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    st.write_wav(p, torch.from_numpy(x), fs)
    ref.write_wav(q, x, fs)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    y, rate = st.read_wav(p)
    y_ref, rate_ref = ref.read_wav(p)
    assert rate == rate_ref == fs and y.device.type == "cpu"
    _eq(y, y_ref)
    assert np.corrcoef(x, y.numpy()[: len(x)])[0, 1] > 0.999


def test_chain_composition():
    f = st.chain(lambda x: st.skiphead(x, 2), lambda x: st.head(x, 3))
    _eq(f(torch.arange(10.0)), [2, 3, 4])
