"""The span reader (`portbench.spans`) on synthetic events, and on the
program's recorder over a CPU sweep call: a launch goes to the innermost
span around its runtime call, a gap to the span covering its midpoint, a
sync is counted where it blocked, an operation no runtime call claims is
listed apart, and a device-side annotation is no device work. On a card
(``-m cuda``), the reader run alone on each cell ties every operation."""

import json
import subprocess
import sys
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, trace
from portbench import spans as reader
from portbench.spans import OUTSIDE, Event

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def _recorded(*spans):
    return [types.SimpleNamespace(name=n, start_ns=s, end_ns=e, parent=p, unit=0, counts=c)
            for n, s, e, p, c in spans]


# two units of an outer span with one child each; the device works in three
# pieces a unit, with a gap inside the child, one inside the outer span's
# own time and one between units (outside the program)
RECORDED = _recorded(("lora.demodulate", 0, 100, -1, {"frames": 4}),
                     ("lora.demodulate_symbols", 10, 60, 0, {"rows": 8, "k": 128}),
                     ("lora.demodulate", 200, 300, -1, {"frames": 4}),
                     ("lora.demodulate_symbols", 210, 260, 2, {"rows": 8, "k": 128}))
LAUNCHED_AT = (15, 35, 75, 215, 235, 275)
DEVICE_A = [Event("k", t + 5, t + 15, t) for t in LAUNCHED_AT]
HOST_A = [Event("cudaLaunchKernel", t, t + 1, t) for t in LAUNCHED_AT]


def test_segment_a_gaps_go_to_the_span_over_their_midpoint():
    a = reader.reduce_recorded(RECORDED, DEVICE_A, HOST_A)
    assert a["units"] == 2
    t = a["tally"]
    # 30-40 and 230-240 inside the child; 50-80 and 250-280 in the outer
    # span's own time; 90-220 between units
    assert t.own["lora.demodulate_symbols"]["idle_ns"] == 20
    assert t.own["lora.demodulate"]["idle_ns"] == 60
    assert t.own[OUTSIDE]["idle_ns"] == 130
    assert t.inclusive["lora.demodulate"]["idle_ns"] == 80
    assert t.own["lora.demodulate"]["host_ns"] == 100 and t.inclusive["lora.demodulate"][
        "host_ns"] == 200
    assert t.inclusive["lora.demodulate"]["launches"] == 6
    assert t.own["lora.demodulate_symbols"]["launches"] == 4 and t.own["lora.demodulate"][
        "launches"] == 2


def test_segment_b_ties_launches_through_correlation_and_counts_syncs():
    names = {"lora.loopback_ber", "channel.awgn"}
    host = [Event("lora.loopback_ber", 0, 100, 1), Event("channel.awgn", 10, 50, 2),
            Event("aten::add", 12, 14, 3),                  # a CPU op's id, not CUPTI's
            Event("cudaLaunchKernel", 20, 21, 7), Event("cudaLaunchKernel", 60, 61, 8),
            Event("cudaMemcpyAsync", 120, 121, 9), Event("cudaStreamSynchronize", 30, 45, 10),
            Event("cudaStreamSynchronize", 130, 140, 11)]
    device = [Event("awgn_kernel", 25, 35, 7), Event("ber_kernel", 62, 70, 8),
              Event("Memcpy DtoH", 122, 125, 9), Event("lost_kernel", 150, 151, 3)]
    b = reader.reduce_traced(host, device, names)
    assert b["units"] == 1
    t = b["tally"]
    assert t.own["channel.awgn"]["launches"] == 1 and t.own["channel.awgn"]["device_ns"] == 10
    assert t.inclusive["lora.loopback_ber"]["launches"] == 2
    assert t.inclusive["lora.loopback_ber"]["device_ns"] == 18
    assert t.own["lora.loopback_ber"]["device_ns"] == 8
    assert t.own[OUTSIDE]["launches"] == 1 and t.own[OUTSIDE]["syncs"] == 1
    assert t.own["channel.awgn"]["syncs"] == 1 and t.inclusive["lora.loopback_ber"]["syncs"] == 1
    assert b["untied"] == {"lost_kernel": 1}       # its id is an aten op's, not a runtime call's


def test_table_and_numbers_from_both_segments():
    a = reader.reduce_recorded(RECORDED, DEVICE_A, HOST_A)
    host = [Event("lora.demodulate", 0, 100, 1), Event("lora.demodulate_symbols", 10, 60, 2),
            Event("lora.decode_symbols", 60, 90, 3)]
    host += [Event("cudaLaunchKernel", t, t + 1, 100 + t) for t in (15, 35, 75)]
    device = [Event("k", 20, 30, 115), Event("k", 40, 50, 135), Event("k", 80, 90, 175)]
    table = reader.span_table(a, reader.reduce_traced(host, device, reader.program_spans().NAMES))
    demod = table["spans"]["lora.demodulate"]
    assert (table["units_a"], table["units_b"]) == (2, 1)
    assert demod["calls"] == 1 and demod["host_ms"] == 100e-6 and demod["launches"] == 3
    assert demod["counts"] == {"frames": 4} and demod["host_ms_median"] == 100e-6
    assert demod["launches_a"] == 3
    assert table[OUTSIDE]["idle_ms"] == 130e-6 / 2
    got = reader.span_metrics(table)
    assert set(got) == {"enqueue_ms.rx", "launches.rx", "syncs.rx", "decode_span_ms.rx",
                        "demod_span_roofline.rx"}
    assert got["launches.rx"] == 3 and got["syncs.rx"] == 0
    assert got["decode_span_ms.rx"] == pytest.approx(10e-6)


def test_a_program_without_spans_reads_all_outside():
    a = reader.reduce_recorded([], DEVICE_A, HOST_A)
    b = reader.reduce_traced(HOST_A, [Event("k", 20, 30, 15)], frozenset())
    table = reader.span_table(a, b)
    assert table["spans"] == {} and (table["units_a"], table["units_b"]) == (0, 0)
    assert table[OUTSIDE]["idle_ms"] == pytest.approx(210e-6) and table[OUTSIDE]["launches"] == 1
    assert reader.span_metrics(table) == {}


def test_the_recorder_over_a_cpu_sweep_gives_the_sweep_table():
    from r4w_tpu_torch.observe import recording
    from r4w_tpu_torch.waveforms import lora

    params = lora.LoRaParams(sf=7)
    payload = torch.arange(12, dtype=torch.int32).reshape(2, 1, 6)
    with recording() as rec:
        lora.loopback_ber(params, payload, torch.tensor([0.0, 3.0]),
                          generator=torch.Generator().manual_seed(3))
    a = reader.reduce_recorded(rec.spans, [], [])
    host = [Event(s.name, s.start_ns, s.end_ns, 0) for s in rec.spans]
    table = reader.span_table(a, reader.reduce_traced(host, [], reader.program_spans().NAMES))
    assert table["units_a"] == table["units_b"] == 1
    assert set(table["spans"]) == reader.program_spans().NAMES
    assert table["spans"]["lora.demodulate_symbols"]["counts"]["rows"] == 4 * 10
    got = reader.span_metrics(table)
    assert got["launches.sim"] == 0 and got["channel_span_ms.sim"] == 0
    assert "demod_span_roofline.sim" not in got          # no device time to divide by


def _kineto(name, start, end, device, annotation=False):
    return types.SimpleNamespace(
        name=lambda: name, is_hidden_event=lambda: False, is_user_annotation=lambda: annotation,
        device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU,
        start_ns=lambda: start, duration_ns=lambda: end - start, correlation_id=lambda: 0)


def test_an_annotation_over_a_gap_is_no_device_work():
    events = [_kineto("kernel", 0, 10, True), _kineto("kernel", 30, 40, True),
              _kineto("cudaLaunchKernel", 0, 1, False)]
    prof = lambda evs: types.SimpleNamespace(   # noqa: E731
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: evs)))
    plain = reader.kineto_events(prof(events))
    annotated = reader.kineto_events(prof(events + [_kineto("lora.demodulate", 0, 40, True,
                                                            annotation=True)]))
    assert annotated == plain
    assert reader.idle_gaps(annotated[0]) == [(10, 30)]
    # the benchmark's reduction reads the same busy time and gaps from them
    dev = [(e.name, e.start / 1e9, e.end / 1e9) for e in annotated[0]]
    assert trace.reduce_events(dev, [])["busy_s"] == pytest.approx(20e-9)



@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_reader_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/spans.py", "--workload", name, "--seed",
                          "2147483711"], capture_output=True, text=True, cwd=harness.CHECKOUT,
                         timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    table, got = res["spans"], res["metrics"]
    assert table["untied"] == {} and table["units_a"] > 0 and table["units_b"] > 0
    assert len(got) == 5 and all(v is not None and v >= 0 for v in got.values())
    counts = [v for k, v in got.items() if k.split(".")[0] in ("launches", "syncs")]
    assert len(counts) == 2 and all(v == int(v) for v in counts)
    for row in table["spans"].values():
        assert row["launches_a"] == row["launches"], row
