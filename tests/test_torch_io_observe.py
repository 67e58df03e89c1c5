"""IQ formats, SigMF, the capture manager, metrics, logging and config
against the JAX package's, paired with tests/test_io_cli.py.

Bytes, files and metadata equal the reference's for the same samples
(tensors read to the host once); capture recordings equal the reference
manager's on the same blocks, including its history quirk (a threshold
trigger inside a block records the whole block in the history); the
Prometheus text, the HTTP export, log records and configs equal.
"""

import json
import logging
import urllib.request

import numpy as np
import pytest
import torch

from r4w_tpu import config as ref_config
from r4w_tpu.io import iqformat as ref_iq
from r4w_tpu.io import sigmf as ref_sigmf
from r4w_tpu.observe import CaptureConfig as RefCaptureConfig
from r4w_tpu.observe import CaptureManager as RefCaptureManager
from r4w_tpu.observe import MetricsRegistry as RefRegistry
from r4w_tpu_torch import config as cfgmod
from r4w_tpu_torch.io import iqformat, sigmf
from r4w_tpu_torch.observe import (CaptureConfig, CaptureManager, CaptureState, MetricsRegistry,
                                   Timer, get_logger, init_logging, serve_metrics)

FORMATS = ("cf64", "cf32", "ci16", "ci8", "cu8")


def _tone(n=1000):
    return np.exp(1j * 0.05 * np.arange(n)).astype(np.complex64)


@pytest.mark.parametrize("fmt", FORMATS)
def test_iq_bytes_equal_the_reference(fmt):
    x = 0.9 * _tone(256)
    raw = iqformat.encode_samples(torch.from_numpy(x), fmt)
    assert raw == ref_iq.encode_samples(x, fmt)
    assert len(raw) == 256 * iqformat.bytes_per_sample(fmt)
    np.testing.assert_array_equal(iqformat.decode_samples(raw, fmt),
                                  ref_iq.decode_samples(raw, fmt))


def test_iq_errors_and_sigmf_types():
    with pytest.raises(ValueError, match="unknown IQ format"):
        iqformat.encode_samples(_tone(4), "cf16")
    assert iqformat.list_formats() == ref_iq.list_formats()
    assert [iqformat.from_sigmf_datatype(d) for d in iqformat.SIGMF_DATATYPES.values()] == list(
        FORMATS)


def test_iq_files_and_convert(tmp_path):
    x = 0.5 * _tone(1000)
    src, dst = str(tmp_path / "a.iq"), str(tmp_path / "b.iq")
    iqformat.write_iq_file(src, torch.from_numpy(x), "cf32")
    iqformat.convert_iq_file(src, dst, "cf32", "ci16", block_samples=300)
    ref_iq.convert_iq_file(src, str(tmp_path / "c.iq"), "cf32", "ci16")
    assert (tmp_path / "b.iq").read_bytes() == (tmp_path / "c.iq").read_bytes()
    back = iqformat.read_iq_file(dst, "ci16", max_samples=600)
    assert back.shape == (600,) and np.max(np.abs(back - x[:600])) < 1e-3


def test_sigmf_equal_the_reference(tmp_path):
    x = _tone(512)
    p, q = str(tmp_path / "rec.sigmf-data"), str(tmp_path / "ref.sigmf")
    sigmf.write_sigmf(p, torch.from_numpy(x), 2e6, frequency=868.1e6, description="test")
    ref_sigmf.write_sigmf(q, x, 2e6, frequency=868.1e6, description="test")
    assert (tmp_path / "rec.sigmf-meta").read_text() == (tmp_path / "ref.sigmf-meta").read_text()
    assert (tmp_path / "rec.sigmf-data").read_bytes() == (tmp_path / "ref.sigmf-data").read_bytes()
    back, meta = sigmf.read_sigmf(p)
    np.testing.assert_array_equal(back, x)
    assert (meta.sample_rate, meta.frequency) == (2e6, 868.1e6)
    assert json.loads((tmp_path / "rec.sigmf-meta").read_text())["global"]["core:version"]
    assert sigmf.sigmf_exists(p) and not sigmf.sigmf_exists(str(tmp_path / "none"))


def _feed(manager, blocks, levels, triggers):
    manager.arm()
    for b, level, manual in zip(blocks, levels, triggers):
        if manual:
            manager.trigger()
        manager.process(b, trigger_level=level)
    return manager


CAPTURE_CASES = {
    # tests/test_io_cli.py:test_capture_arm_trigger_save
    "threshold": ([0.001 * _tone(100), np.concatenate([0.001 * _tone(50), _tone(100)])
                   .astype(np.complex64), _tone(200)], [0.5] * 3, [False] * 3),
    "manual": ([0.001 * _tone(300), _tone(40), _tone(200)], [None] * 3, [False, True, False]),
}


@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_capture_equals_the_reference(tmp_path, case):
    blocks, levels, triggers = CAPTURE_CASES[case]
    got = _feed(CaptureManager(CaptureConfig(pre_trigger_samples=64, post_trigger_samples=128),
                               device="cpu"), [torch.from_numpy(b) for b in blocks], levels,
                triggers)
    want = _feed(RefCaptureManager(RefCaptureConfig(pre_trigger_samples=64,
                                                    post_trigger_samples=128)),
                 blocks, levels, triggers)
    assert got.state == CaptureState.COMPLETE and want.state.value == "complete"
    np.testing.assert_array_equal(got.samples().numpy(), want.samples())
    got.save(str(tmp_path / "a.sigmf-data"))
    want.save(str(tmp_path / "b.sigmf-data"))
    assert got.state == CaptureState.IDLE
    assert (tmp_path / "a.sigmf-meta").read_text() == (tmp_path / "b.sigmf-meta").read_text()
    assert (tmp_path / "a.sigmf-data").read_bytes() == (tmp_path / "b.sigmf-data").read_bytes()
    x, meta = sigmf.read_sigmf(str(tmp_path / "a.sigmf-data"))
    assert len(x) >= 128 and meta.annotations[0]["core:label"] == "trigger"


def test_capture_stays_armed_below_the_level():
    cm = CaptureManager(CaptureConfig(pre_trigger_samples=64), device="cpu")
    cm.arm()
    cm.process(torch.from_numpy(0.001 * _tone(100)), trigger_level=0.5)
    assert cm.state == CaptureState.ARMED and cm.pre_count == 64


def _registries():
    out = []
    for reg in (MetricsRegistry(), RefRegistry()):
        reg.counter("r4w_blocks_total", "processed blocks").inc(5)
        reg.gauge("r4w_snr_db").set(12.5)
        h = reg.histogram("r4w_latency_seconds", buckets=(0.001, 0.01, 0.1))
        for v in (0.005, 0.0005, 7.0):
            h.observe(v)
        out.append(reg)
    return out


def test_metrics_text_equals_the_reference():
    got, want = _registries()
    assert got.to_prometheus() == want.to_prometheus()
    text = got.to_prometheus()
    assert "r4w_blocks_total 5.0" in text and 'r4w_latency_seconds_bucket{le="0.001"} 1' in text
    h = got.histogram("r4w_latency_seconds")
    assert (h.quantile(0.5), h.quantile(0.99)) == (0.01, float("inf"))
    g = got.gauge("g")
    g.inc(2.0)
    g.dec(0.5)
    assert g.value == 1.5
    with Timer(got.histogram("t")):
        pass
    assert got.histogram("t").total == 1


def test_metrics_http_server():
    reg = MetricsRegistry()
    reg.counter("test_hits").inc()
    server = serve_metrics(port=0, registry=reg, host="127.0.0.1")
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=5).read().decode()
        assert "test_hits 1.0" in body
    finally:
        server.shutdown()
        server.server_close()


def test_logging_json_and_profiles(monkeypatch, capsys):
    monkeypatch.delenv("R4W_LOG", raising=False)
    logger = init_logging("prod")
    assert logger.name == "r4w_tpu_torch" and logger.level == logging.INFO
    get_logger("sim").info("hello %d", 3)
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert (rec["level"], rec["target"], rec["message"]) == ("INFO", "r4w_tpu_torch.sim", "hello 3")
    monkeypatch.setenv("R4W_LOG", "error")
    assert init_logging("dev").level == logging.ERROR
    assert init_logging("quiet", level="debug").level == logging.DEBUG
    assert get_logger().name == "r4w_tpu_torch"
    logging.getLogger("r4w_tpu_torch").handlers.clear()


def test_config_equals_the_reference(tmp_path):
    assert cfgmod.R4wConfig().validate() == [] == ref_config.R4wConfig().validate()
    p = tmp_path / "r4w.yaml"
    p.write_text("device:\n  sample_rate: 250000\n"
                 "profiles:\n  lab:\n    device:\n      gain_db: 10\n")
    cfg, want = cfgmod.R4wConfig.load_from(str(p)), ref_config.R4wConfig.load_from(str(p))
    assert cfg.to_dict() == want.to_dict() and cfg.device.sample_rate == 250000
    lab = cfg.with_profile("lab")
    assert lab.to_dict() == want.with_profile("lab").to_dict() and lab.device.gain_db == 10
    with pytest.raises(KeyError):
        cfg.with_profile("nope")
    assert cfg.to_yaml() == want.to_yaml()
    assert cfgmod.R4wConfig.example_yaml() == ref_config.R4wConfig.example_yaml()
    bad = cfgmod.R4wConfig()
    bad.metrics.port = 99999
    bad.realtime.priority = 120
    ref_bad = ref_config.R4wConfig()
    ref_bad.metrics.port = 99999
    ref_bad.realtime.priority = 120
    assert bad.validate() == ref_bad.validate() and any("port" in e for e in bad.validate())


def test_config_from_dict_profile():
    raw = {"buffer": {"block_size": 1024},
           "profiles": {"scene": {"capture": {"pre_trigger_samples": 16}}}}
    cfg = cfgmod.R4wConfig.from_dict(raw).with_profile("scene")
    assert (cfg.buffer.block_size, cfg.capture.pre_trigger_samples) == (1024, 16)
    assert cfg.to_dict() == ref_config.R4wConfig.from_dict(raw).with_profile("scene").to_dict()
