"""The port's explorer (``r4w_tpu_torch.explorer``) against ``r4w_tpu.explorer``.

Both servers run here on ephemeral ports, the port's on the CPU; the same
requests go to both. The page, the waveform list, the block catalog and
its schemas, the sky view and the error answers are equal; the demo's
decisions are equal and its float metrics within `METRIC_REL_TOL`
(float32 estimates summed in another order); the pipeline wizard's report
is within the registry pipeline tests' tolerances of JAX's `run_pipeline`; the live waterfall's
rows are JAX's `Waterfall` of the same samples within one rounding step of
the JSON (0.1 dB).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from r4w_tpu import explorer as ref_explorer
from r4w_tpu import pipeline as ref_pipeline
from r4w_tpu.analysis import Waterfall as RefWaterfall
from r4w_tpu_torch import explorer, remote_gates
from r4w_tpu_torch.channel.channel import ChannelModelName
from r4w_tpu_torch.waveforms import create_waveform
from test_torch_registry_pipeline import ARRAY_TYPES, SCHEMA_EXEMPT, SCHEMA_KEYS

METRIC_REL_TOL = 1e-5       # the demo's SNR and EVM estimates, float32
REPORT_POWER_TOL = 0.005 + 1e-6    # tests/test_torch_registry_pipeline.py: the
REPORT_PREVIEW_TOL = 0.005 + 1e-6  # reference rounds power and previews to 0.01
ROW_TOL_DB = 0.1 + 1e-4     # rows are rounded to 0.1 dB on both sides
STREAM_WAIT_S = 20.0
DEMO_CASES = (("QPSK", "awgn"), ("LoRa-SF7", "rayleigh"), ("BPSK", "tdl_awgn"),
              ("QPSK", "jakes"), ("QPSK", "none"))


@pytest.fixture(scope="module")
def servers():
    port = explorer.serve(port=0, background=True, device="cpu")
    ref = ref_explorer.serve(port=0, background=True)
    urls = tuple("http://%s:%d" % s.server_address[:2] for s in (port, ref))
    yield urls
    for s in (port, ref):
        s.shutdown()
        s.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _get_json(url):
    return json.loads(_get(url)[2])


def _post(url, obj, headers=None):
    body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=body, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_page_equals_reference(servers):
    (s1, t1, page), (s2, t2, ref) = _get(servers[0] + "/"), _get(servers[1] + "/")
    assert s1 == s2 == 200 and t1 == t2 == "text/html"
    assert page == ref
    for marker in (b"r4w-tpu explorer", b"/api/demo", b"pipeline wizard", b"gnss sky",
                   b"api/pipeline", b"awgn_cfo", b"tdl_awgn", b"jakes"):
        assert marker in page


@pytest.mark.parametrize("path", ["/api/waveforms", "/api/blocks", "/api/blocks?q=golay",
                                  "/api/blocks?schema=1&q=fir", "/api/blocks?jit=1&q=crc",
                                  "/api/demo?name=NOPE", "/api/demo?name=BPSK&hex=ZZ",
                                  "/api/stream/rows?since=0"])
def test_json_get_equals_reference(servers, path):
    got, want = _get_json(servers[0] + path), _get_json(servers[1] + path)
    if path.startswith("/api/blocks?jit=1"):
        # the registry's jit probe is left out: the rows are the catalog's
        want = [{k: v for k, v in row.items() if not k.startswith("jit")} for row in want]
    if "schema=1" in path:
        # the schemas as tests/test_torch_registry_pipeline.py holds them:
        # their keys, array types named "array", the port's keyword-only keys
        got, want = _schemas(got), _schemas(want)
        assert len(got) > 10
    assert got == want
    if path == "/api/blocks":
        assert len(got) == 523


def _schemas(rows: list) -> list:
    out = []
    for row in rows:
        entries = []
        for entry in row.pop("schema"):
            kept = {k: ARRAY_TYPES.get(entry[k], entry[k]) if k == "type" else entry[k]
                    for k in SCHEMA_KEYS
                    if (row["name"], entry["name"], k) not in SCHEMA_EXEMPT}
            entries.append(kept)
        out.append((row, entries))
    return out


def test_not_found(servers):
    for url in servers:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + "/api/nothing")
        assert e.value.code == 404


def test_cross_origin_post_rejected(servers):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(servers[0] + "/api/stream/stop", {}, {"Origin": "https://evil.example"})
    assert e.value.code == 403
    assert json.loads(e.value.read()) == {"error": "cross-origin POST rejected"}
    assert _post(servers[0] + "/api/stream/stop", {}, {"Origin": "http://localhost:8080"}) \
        == {"stopped": False}


def _metrics_close(got: dict, want: dict, clean: bool = False) -> None:
    """Decisions equal, float estimates within `METRIC_REL_TOL`. Of a clean
    signal (no channel), the SNR and EVM estimates measure the two
    demodulators' rounding alone (the port's can be exactly 0 error, 240
    dB), so they are not compared."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if clean and k in ("snr_estimate_db", "evm_rms"):
            continue
        if isinstance(w, float) and not isinstance(w, bool) and k != "sample_rate":
            assert abs(g - w) <= METRIC_REL_TOL * max(abs(w), 1.0), (k, g, w)
        else:
            assert g == w, (k, g, w)


@pytest.mark.parametrize("name,channel", DEMO_CASES)
def test_demo_metrics_equal_reference(servers, name, channel):
    query = f"/api/demo?name={name}&hex=A71B3CD2&channel={channel}&snr=15&cfo_hz=200"
    got, want = _get_json(servers[0] + query), _get_json(servers[1] + query)
    assert "error" not in got, got.get("error")
    _metrics_close(got["metrics"], want["metrics"], clean=channel == "none")
    assert got["stages"] == want["stages"]
    assert sorted(got["plots"]) == ["constellation", "spectrum", "time", "waterfall"]
    assert all(len(v) > 1000 for v in got["plots"].values())  # real base64 PNGs


def test_run_demo_is_the_round_and_its_drawing():
    direct = explorer.run_demo("BPSK", "A7", channel="awgn", device="cpu")
    round_ = explorer.demo_round("BPSK", "A7", channel="awgn", device="cpu")
    assert direct["metrics"] == round_["metrics"] and direct["stages"] == round_["stages"]
    assert direct["metrics"]["decoded_ok"] is True
    f, db = round_["spectrum"]
    assert f.shape == db.shape and round_["waterfall"].ndim == 2
    assert round_["rx"].shape == (round_["metrics"]["samples"],)


def test_demo_round_over_the_nine_models_on_key_0():
    """The round on the channel models of `ChannelModelName` that
    `DEMO_CASES` leaves out decides as JAX's `run_demo` does on key 0."""
    import typing

    names = typing.get_args(ChannelModelName)
    assert len(names) == 9
    assert {c for _, c in DEMO_CASES} <= set(names) | {"none"}
    for channel in sorted(set(names) - {c for _, c in DEMO_CASES}):  # the rest of the nine
        got = explorer.demo_round("BPSK", "C3", channel=channel, snr_db=20, cfo_hz=50,
                                  doppler_hz=5, rician_k=12, device="cpu")
        want = ref_explorer.run_demo("BPSK", "C3", channel=channel, snr_db=20, cfo_hz=50,
                                     doppler_hz=5, rician_k=12)
        _metrics_close(got["metrics"], want["metrics"], clean=channel in ("none", "ideal"))


@pytest.mark.parametrize("preset", ["e1c_8prn", "gps_l1ca_6sv"])
@pytest.mark.parametrize("t", ["0", "300"])
def test_gnss_sky_equals_reference(servers, preset, t):
    query = f"/api/gnss_sky?preset={preset}&t={t}"
    got, want = _get_json(servers[0] + query), _get_json(servers[1] + query)
    assert got == want
    assert len(got["sats"]) == (8 if preset == "e1c_8prn" else 6)


def test_gnss_sky_yaml_post_equals_reference(servers):
    yaml_text = (b"satellites:\n  - prn: 5\n    signal: galileoe1c\n    cn0_dbhz: 40.0\n"
                 b"    elevation_deg: 50.0\n    azimuth_deg: 123.0\n    doppler_hz: 900.0\n")
    got = _post(servers[0] + "/api/gnss_sky?t=12", yaml_text)
    assert got == _post(servers[1] + "/api/gnss_sky?t=12", yaml_text)
    assert got["sats"][0]["azimuth_deg"] == pytest.approx(123.0)


def test_pipeline_endpoint_matches_reference(servers):
    """The block-graph gate's graph at a 16-byte LoRa-SF7 burst through /api/pipeline
    (run at the pipeline's default rate, as the reference's handler does)."""
    nodes = remote_gates.graph_nodes(remote_gates.gate_payload(16))
    got = _post(servers[0] + "/api/pipeline", {"nodes": nodes, "seed": 0})
    assert "error" not in got, got
    want = ref_pipeline.run_pipeline(nodes, seed=0)
    want = json.loads(json.dumps(want))
    assert got["order"] == remote_gates.GRAPH_ORDER
    assert got["nodes"]["rx"]["decoded_ok"] is True
    verdict = remote_gates.compare_reports(got, want, power_tol=REPORT_POWER_TOL,
                                           preview_tol=REPORT_PREVIEW_TOL)
    assert verdict["equal"], verdict["diffs"]


def _wait_rows(url: str, n: int) -> dict:
    deadline = time.monotonic() + STREAM_WAIT_S
    while True:
        out = _get_json(url + "/api/stream/rows?since=0")
        assert "pump_error" not in out["stats"], out["stats"]
        if len(out["rows"]) >= n or time.monotonic() > deadline:
            return out
        time.sleep(0.1)


def test_live_stream_rows_equal_reference_waterfall(servers):
    url = servers[0]
    start = _post(url + "/api/stream/start", {"fs": 250000.0, "fft": 256})
    assert start["port"] > 0 and start["fft"] == 256
    try:
        tx = _post(url + "/api/stream/tx", {"name": "QPSK", "hex": "CAFE1234", "snr": 15,
                                            "reps": 32})
        assert tx["packets"] >= 1, tx
        out = _wait_rows(url, 16)
        assert len(out["rows"]) >= 16, out["stats"]
        assert out["stats"]["dropped"] == 0 and out["stats"]["samples"] == tx["samples"]
        # the same samples through JAX's Waterfall
        iq = create_waveform("QPSK", 250000.0, "cpu").modulate(bytes.fromhex("CAFE1234"))
        iq = np.tile(iq.numpy().astype(np.complex64), 32)
        p = float(np.mean(np.abs(iq) ** 2))
        sigma = np.sqrt(p / (10 ** 1.5 * 2))
        rng = np.random.default_rng(0)
        iq = iq + sigma * (rng.standard_normal(iq.size)
                           + 1j * rng.standard_normal(iq.size)).astype(np.complex64)
        # rows are frames of 256 samples (hop 256) in stream order; the answer
        # holds the newest, ending at absolute row `next`
        frames = np.round(np.asarray(RefWaterfall(250000.0, 256, hop=256).compute(
            iq[:out["next"] * 256].astype(np.complex64))), 1)
        got = np.asarray(out["rows"])
        want = frames[out["next"] - len(got):]
        assert got.shape == want.shape and got.shape[1] == 256
        assert float(np.max(np.abs(got - want))) <= ROW_TOL_DB
        nxt = out["next"]
        assert _get_json(url + f"/api/stream/rows?since={nxt}")["next"] >= nxt
    finally:
        assert _post(url + "/api/stream/stop", {}) == {"stopped": True}


def test_remote_agent_to_waterfall(servers):
    from r4w_tpu_torch.agent import AgentServer

    url = servers[0]
    agent = AgentServer(port=0, device="cpu")
    agent.serve_in_thread()
    try:
        a = {"agent_host": "127.0.0.1", "agent_port": agent.port}
        assert _post(url + "/api/remote", {**a, "command": "ping"})["response"] == "pong"
        err = _post(url + "/api/remote", {**a, "command": "start_tx", "target": "stream"})
        assert err == {"response": "error", "message": "start the live stream first"}
        assert _post(url + "/api/stream/start", {"fs": 125000.0, "fft": 128})["port"] > 0
        try:
            tx = _post(url + "/api/remote", {**a, "command": "start_tx", "target": "stream",
                                             "waveform": "QPSK", "message": "remote lab",
                                             "repeat": True, "pps": 50})
            assert tx["response"] == "ok", tx
            out = _wait_rows(url, 1)
            assert _post(url + "/api/remote", {**a, "command": "stop_tx"})["response"] == "ok"
            assert out["rows"] and len(out["rows"][0]) == 128, out["stats"]
        finally:
            _post(url + "/api/stream/stop", {})
    finally:
        agent._running = False
        agent.join_tx(5.0)


def test_remote_unreachable_agent(servers):
    out = _post(servers[0] + "/api/remote", {"agent_host": "127.0.0.1", "agent_port": 1,
                                             "command": "ping"})
    assert out["response"] == "error" and "cannot reach agent" in out["message"]


def test_stream_pump_error_reaches_the_json(monkeypatch):
    """A failure in the waterfall pump shows as `pump_error` in the rows."""
    def broken(self, block):
        raise RuntimeError("pump broke")

    monkeypatch.setattr(explorer._StreamSession, "_rows_of", broken)
    session = explorer._StreamSession(fs=250000.0, fft_size=128, device="cpu")
    try:
        deadline = time.monotonic() + 5.0
        while session.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert session.rows_since(0)["stats"]["pump_error"] == "RuntimeError: pump broke"
    finally:
        session.stop()


def test_serve_builds_kernels_only_for_the_card(monkeypatch):
    from r4w_tpu_torch.kernels import _build

    calls = []
    monkeypatch.setattr(_build, "ensure_built", lambda names=None: calls.append(names) or {})
    explorer.build_kernels("cpu")
    assert calls == []
    explorer.build_kernels(torch.device("cuda"))
    assert calls == [None]


def test_compare_demo_waterfall_as_amplitudes():
    """The card's demo check: decisions exact, the spectrum in dB, the
    waterfall as amplitudes over its largest (a sidelobe 100 dB down may
    move by a dB: that is rounding)."""
    from r4w_tpu_torch import frontend_gates

    rng = np.random.default_rng(3)
    fall = rng.uniform(-40.0, 0.0, (6, 16)).astype(np.float32)
    fall[0, 0] = -100.0
    base = {"m": {"metrics": {"decoded_ok": True, "decoded_hex": "ab", "snr_estimate_db": 12.5,
                              "samples": 10},
                  "stages": ["a"], "spectrum_db": np.zeros(8, np.float32), "waterfall_db": fall}}

    def variant(**change):
        return {"m": {**base["m"], **change}}

    assert frontend_gates.compare_demo(base, base)["equal"]
    deep = fall.copy()
    deep[0, 0] = -99.0
    verdict = frontend_gates.compare_demo(variant(waterfall_db=deep), base)
    assert verdict["equal"] and verdict["worst_waterfall_db"] == pytest.approx(1.0)
    assert verdict["worst_waterfall_rel"] < 1e-5
    loud = fall.copy()
    loud[1, 1] = max(float(loud.max()), -1.0) + 0.01
    assert not frontend_gates.compare_demo(variant(waterfall_db=loud), base)["equal"]
    spec = np.full(8, 0.01, np.float32)
    assert not frontend_gates.compare_demo(variant(spectrum_db=spec), base)["equal"]
    metrics = {**base["m"]["metrics"], "decoded_hex": "ac"}
    assert not frontend_gates.compare_demo(variant(metrics=metrics), base)["equal"]
    metrics = {**base["m"]["metrics"], "snr_estimate_db": 12.5 * (1 + 1e-5)}
    assert frontend_gates.compare_demo(variant(metrics=metrics), base)["equal"]
