"""The harness finds a cell's configuration, traffic and metrics by name, a
new file is picked up without an edit to any existing one, and
BENCHMARK.json keeps to the benchmark's format."""

import json
import re
import shutil
import time
import types

import pytest

from portbench import harness, roofline, trace

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        traffic = harness.load_generator(cell.traffic["generator"]).Traffic
        assert all(callable(getattr(traffic, m)) for m in ("segment", "window", "stepped", "judge"))
        assert all(int(cell.traffic[k]) > 0 for k in ("warm", "profiled", "breakdown", "stepped"))
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_files_declare_what_benchmark_json_says(kind):
    for m in BENCH[kind]:
        module = harness.load_metric(m["name"])
        assert module.UNIT == m["unit"]
        assert module.SOURCE == m["source"]
        if kind == "per_layer":
            assert module.LAYER == m["layer"]
            assert module.MOVES == m["moves"]
        assert module.compute({}) is None or m["name"] == "setup_s"


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (harness.CHECKOUT / c["file"]).is_file()
        assert c["file"].startswith("portbench/") and 1 <= len(c["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source",
                                          "layer", "moves"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert harness._reports(e2e[m["moves"]], w)
    for w in BENCH["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.ROOT / sub, root / sub)
    cfg = json.loads((root / "configs" / "lorawan_eu868_dr5.json").read_text())
    (root / "configs" / "new_cfg.json").write_text(json.dumps({**cfg, "name": "new_cfg"}))
    tr = json.loads((root / "traffic" / "mc_sweep.json").read_text())
    (root / "traffic" / "new_mix.json").write_text(json.dumps({**tr, "lanes_at_sf7": 8}))
    (root / "metrics" / "calls_done.sim.py").write_text(
        'UNIT = "calls"\nLAYER = "Entry"\nMOVES = "sim_mbps"\nSOURCE = "program_counter"\n\n'
        'def compute(rec):\n    return rec.get("calls")\n')
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("new_cfg.new_mix")
    bench["per_layer"].append({"name": "calls_done.sim", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "Entry",
                               "moves": "sim_mbps", "workloads": ["new_cfg.new_mix"]})
    cell = harness.find_cell("new_cfg.new_mix", bench, root)
    assert cell.traffic["lanes_at_sf7"] == 8 and cell.config["name"] == "new_cfg"
    assert cell.per_layer == ("calls_done.sim",)
    assert "sim_mbps" in cell.end_to_end
    out = harness.compute_metrics(cell.per_layer, {"calls": 7}, root)
    assert out == {"calls_done.sim": {"value": 7.0, "unit": "calls"}}


class _CountingTraffic:
    """A generator of units that do nothing, recording the harness's calls."""

    calls = []

    def __init__(self, cell, seed, device, program):
        self.calls.clear()

    def segment(self, phase, n):
        self.calls.append((phase, n))

    def window(self, seconds):
        self.calls.append(("window", seconds))
        return ({"window_s": 2.0, "attempted": 6, "failed": 0, "payload_bits": 4e6},
                {"units": 6, "anything": [1, 2]})

    def stepped(self, n):
        self.calls.append(("stepped", n))
        return {"stage_ms": {"awgn": 1.5}}, 0

    def judge(self):
        self.calls.append(("judge",))
        return {"gap": {"value": 0.0, "limit": 1.0}}, {"judged": 3}


@pytest.mark.parametrize("traced", [False, True])
def test_every_generator_runs_the_harness_sequence_and_its_info_passes_through(
        monkeypatch, traced):
    monkeypatch.setattr(harness, "load_generator",
                        lambda name: types.SimpleNamespace(Traffic=_CountingTraffic))
    monkeypatch.setattr(trace, "profile_segments",
                        lambda run, device, a, b: (run(a), run(b)) and {
                            "busy_s": 0.5, "span_s": 1.0, "breakdown": {"device_ops": []}})
    cell = harness.find_cell("lorawan_eu868_dr5.mc_sweep")
    res = harness.run_cell(cell, 9, 2.0, traced, "cpu", time.perf_counter())
    tr = cell.traffic
    want = [("warm", tr["warm"]), ("window", 2.0)]
    if traced:
        want += [("profiled", tr["profiled"]), ("profiled", tr["breakdown"]),
                 ("stepped", tr["stepped"])]
    assert _CountingTraffic.calls == want + [("judge",)]
    assert res["info"]["units"] == 6 and res["info"]["anything"] == [1, 2]
    assert res["info"]["judged"] == 3 and res["info"]["window_s"] == 2.0
    assert res["correct"] and list(res)[-1] == "checks"
    if traced:
        assert res["metrics"]["channel_ms.sim"]["value"] == 1.5
        assert res["checks"]["stepped_mismatch"]["value"] == 0
        assert res["device"]["busy_s"] == 0.5 and res["device"]["window_s"] == 1.0
    else:
        assert res["metrics"]["sim_mbps"]["value"] == 2.0


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    assert harness.compute_metrics(["channel_ms.sim", "decode_ms.rx"], {"stage_ms": {}}) == {}


def test_seeds_take_large_and_negative_numbers_and_differ_by_tag():
    a = harness.seed_of(2 ** 33 + 5, 1, 0)
    assert 0 <= a < 2 ** 63 and a == harness.seed_of(2 ** 33 + 5, 1, 0)
    assert a != harness.seed_of(2 ** 33 + 5, 1, 1) != harness.seed_of(-3, 1, 1)


def test_roofline_counts_follow_their_formulas():
    rows, k = 30080, 2048
    assert roofline.demod_bytes(rows, k) == rows * k * 8 + k * 8 + rows * 12
    assert roofline.demod_flops(rows, k) == rows * k * (6 + 55 + 3)
    least, by = roofline.least_seconds(roofline.demod_bytes(rows, k),
                                       roofline.demod_flops(rows, k))
    assert by == "bytes" and abs(least - 493_208_064 / 3.35e12) < 1e-9
    assert roofline.demod_share(rows, k, 2 * least) == pytest.approx(50.0)


def test_trace_reduction_busy_span_and_gaps():
    device = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("k1", 3.0, 4.0)]
    host = [("outer", 0.0, 5.0), ("cudaEventSynchronize", 2.1, 2.9)]
    out = trace.reduce_events(device, host)
    assert out["busy_s"] == 3.0 and out["span_s"] == 4.0
    assert out["breakdown"]["device_ops"] == [["k1", 2.0], ["k2", 1.5]]
    assert out["breakdown"]["idle_gaps"] == [["cudaEventSynchronize", 1.0]]
    with pytest.raises(RuntimeError):
        trace.reduce_events([], host)
