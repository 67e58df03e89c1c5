"""The spans at the layer boundaries of the port's LoRa path
(`r4w_tpu_torch.observe.spans`), on the CPU.

Off, a span changes no output and enters no profiler range; under a
recorder the sweep's call records the span tree of its layers with the
call's shapes as count attributes; under ``torch.profiler`` each span is a
host range of the trace and no user annotation; the recorder's clock lies
on Kineto's. `profiling.device_summary` leaves device-side annotations out
of the device's busy time.
"""

import threading
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from r4w_tpu_torch import profiling
from r4w_tpu_torch.observe import recording, spans
from r4w_tpu_torch.waveforms import lora

PARAMS = lora.LoRaParams(sf=7)
LANES, N_BYTES, SNRS = 3, 6, (-4.0, 2.0)
TREE = [("lora.loopback_ber", -1), ("lora.modulate", 0), ("channel.awgn", 0),
        ("lora.demodulate", 0), ("lora.demodulate_symbols", 3), ("lora.decode_symbols", 3)]


def _sweep():
    payload = torch.arange(LANES * N_BYTES, dtype=torch.int32).reshape(LANES, 1, N_BYTES) * 7 % 256
    g = torch.Generator().manual_seed(25)
    return lora.loopback_ber(PARAMS, payload, torch.tensor(SNRS), generator=g)


def _block():
    g = torch.Generator().manual_seed(5)
    n = PARAMS.n_payload_symbols(N_BYTES) * PARAMS.samples_per_symbol
    return torch.complex(torch.randn(2, n, generator=g), torch.randn(2, n, generator=g))


def _demodulate():
    return lora.demodulate(PARAMS, _block())


class _Refuse:
    """Stands in for a profiler range: entering one fails the test."""

    def __init__(self, *args, **kwargs):
        raise AssertionError("a profiler range was entered with tracing off")


def test_off_path_enters_no_range_and_records_nothing(monkeypatch):
    with recording() as rec:
        pass
    monkeypatch.setattr(spans, "_RecordFunctionFast", _Refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _Refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Refuse)
    _sweep()
    _demodulate()
    assert rec.spans == [] and spans._recorder is None


@pytest.mark.parametrize("state", ["recorder", "profiler"])
def test_outputs_equal_with_tracing_off_and_on(state):
    off = (_sweep(), _demodulate())
    if state == "recorder":
        with recording() as rec:
            on = (_sweep(), _demodulate())
        assert len(rec.spans) == len(TREE) + 3
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            on = (_sweep(), _demodulate())
    torch.testing.assert_close(on[0], off[0], rtol=0, atol=0)
    for got, want in zip(on[1], off[1]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_recorder_records_the_span_tree_with_the_call_shapes():
    with recording() as rec:
        ber = _sweep()
        _demodulate()
    sweep, alone = rec.spans[:len(TREE)], rec.spans[len(TREE):]
    assert [(s.name, s.parent) for s in sweep] == TREE
    assert {s.unit for s in sweep} == {0} and rec.units == 2
    for s in sweep:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = sweep[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    symbols = PARAMS.n_payload_symbols(N_BYTES)
    packets = LANES * len(SNRS)
    samples = packets * symbols * PARAMS.samples_per_symbol
    assert ber.shape == (LANES, len(SNRS))
    assert [s.counts for s in sweep] == [
        {"packets": packets, "samples": samples}, {"symbols": LANES * symbols},
        {"samples": samples}, {"frames": packets}, {"rows": packets * symbols, "k": 128},
        {"symbols": packets * symbols}]
    # a demodulate called alone is its own unit
    assert [(s.name, s.parent, s.unit) for s in alone] == [
        ("lora.demodulate", -1, 1), ("lora.demodulate_symbols", len(TREE), 1),
        ("lora.decode_symbols", len(TREE), 1)]
    assert alone[0].counts == {"frames": 2} and alone[1].counts == {"rows": 2 * symbols, "k": 128}


def test_one_recorder_at_a_time_and_one_thread():
    with recording() as rec:
        with pytest.raises(RuntimeError, match="already on"):
            with recording():
                pass
        worker = threading.Thread(target=_demodulate)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
    assert rec.spans == []


def test_profiler_state_marks_host_ranges_without_annotations():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sweep()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in spans.NAMES:
            assert not e.is_user_annotation(), e.name()
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert {name: len(r) for name, r in ranges.items()} == {name: 1 for name, _ in TREE}
    (outer_start, outer_end), = ranges["lora.loopback_ber"]
    for (start, end), in ranges.values():
        assert outer_start <= start <= end <= outer_end


def test_recorder_spans_lie_on_kinetos_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("clock.probe"):
            with recording() as rec:
                _sweep()
    probe, = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock.probe"]
    outer = rec.spans[0]
    assert probe.start_ns() - 1_000_000 <= outer.start_ns <= outer.end_ns
    assert outer.end_ns <= probe.end_ns() + 1_000_000


def _event(name, start_us, end_us, device=True, annotation=False):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU,
        is_hidden_event=lambda: False, is_user_annotation=lambda: annotation,
        start_ns=lambda: int(start_us * 1e3), end_ns=lambda: int(end_us * 1e3),
        duration_ns=lambda: int((end_us - start_us) * 1e3))


def test_device_summary_leaves_annotations_out():
    work = [_event("kernel_a", 0, 10), _event("kernel_b", 30, 40), _event("aten::add", 5, 35,
                                                                          device=False)]
    plain = profiling.device_summary(work)
    assert plain["busy_ms"] == pytest.approx(0.020) and plain["span_ms"] == pytest.approx(0.040)
    annotated = profiling.device_summary(work + [_event("lora.demodulate", 0, 40,
                                                        annotation=True)])
    assert annotated == plain


@pytest.mark.cuda
def test_on_the_card_spans_are_host_ranges_and_no_device_work():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    payload = torch.arange(LANES * N_BYTES, dtype=torch.int32, device="cuda").reshape(
        LANES, 1, N_BYTES)
    g = torch.Generator(device="cuda").manual_seed(25)
    lora.loopback_ber(PARAMS, payload, torch.tensor(SNRS, device="cuda"), generator=g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lora.loopback_ber(PARAMS, payload, torch.tensor(SNRS, device="cuda"), generator=g)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    assert device and not any(e.is_user_annotation() or e.name() in spans.NAMES for e in device)
    host = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    assert spans.NAMES <= host
