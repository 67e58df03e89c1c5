"""The port's block registry, block schema, plugins and block-graph
pipeline against ``r4w_tpu.registry``, ``r4w_tpu.block_schema`` and
``r4w_tpu.pipeline``.

Every one of the reference's 523 blocks is held by category: its name,
category, description and params equal, its factory resolved to the
port's counterpart (the same module path under ``r4w_tpu_torch`` and the
same qualified name), and its parameter schema equal on the reference's
parameters. The pipeline's key slot goes to the reference's keyed blocks
(their draws are held in ``test_torch_scheduler_accel.py``); the gate's graph at a 16-byte payload reports what JAX's reports,
and the reference's own pipeline cases run on the port.
"""

import inspect
import os
import subprocess
import sys
import textwrap
import types as pytypes
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from r4w_tpu import pipeline as ref_pipeline
from r4w_tpu.channel import channel as ref_channel
from r4w_tpu.registry import BlockCategory as RefCategory
from r4w_tpu.registry import default_registry as ref_registry
from r4w_tpu_torch import pipeline, remote_gates
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core import types
from r4w_tpu_torch.registry import BlockCategory, PluginManager, default_registry
from r4w_tpu_torch.waveforms import base as wf_base
from r4w_tpu_torch.waveforms import create_waveform, list_waveforms
from torch_port_proxy import compare
from test_torch_scheduler_accel import KEYED_CASES

REPO = Path(__file__).resolve().parents[1]
SCHEMA_KEYS = ("name", "type", "default", "required", "role")
# The reference annotates some stream parameters with its array types; the
# port's schema calls every array parameter "array".
ARRAY_TYPES = {"jax.Array": "array", "np.ndarray": "array"}
# Where the port's signature rightly differs from the reference's: the
# channel blocks take their key keyword-only (a Philox `generator` is the
# other source), so it is not required; null_source's dtype is torch's.
SCHEMA_EXEMPT = {(b, "key", "required") for b in (
    "awgn_channel", "rayleigh_channel", "phase_noise", "phase_noise_model", "tdl_channel",
    "tapped_delay_line")} | {("null_source", "dtype", "type"), ("null_source", "dtype", "default")}
CH_TOL = 1e-6              # the graph's AWGN node against JAX's on the same key
# the reference rounds its report: power to 0.01 dB, previews to 1e-5 and
# spectra to 0.01 dB, so its values are within half a step of the port's
REPORT_POWER_TOL = 0.005 + 1e-6
REPORT_PREVIEW_TOL = 0.005 + 1e-6


@pytest.fixture(scope="module")
def registries():
    return default_registry(), ref_registry()


def _counterpart(obj) -> tuple:
    """(module path, qualified name) of a factory's product, the port's
    package prefix spelled as the reference's."""
    if isinstance(obj, pytypes.ModuleType):
        return (obj.__name__.replace("r4w_tpu_torch", "r4w_tpu", 1),)
    if isinstance(obj, (tuple, list)):
        return tuple(_counterpart(o) for o in obj)
    target = obj if callable(obj) and (inspect.isfunction(obj) or inspect.isclass(obj)) \
        else type(obj)
    return (target.__module__.replace("r4w_tpu_torch", "r4w_tpu", 1), target.__qualname__)


@pytest.mark.parametrize("category", [c.value for c in RefCategory])
def test_registry_entries_match_reference(registries, category):
    port, ref = registries
    want = ref.list(RefCategory(category))
    got = port.list(BlockCategory(category))
    assert [b.name for b in got] == [b.name for b in want]
    for g, w in zip(got, want):
        assert (g.category.value, g.description, g.params) == (w.category.value, w.description,
                                                               w.params), g.name
        assert _counterpart(g.factory()) == _counterpart(w.factory()), g.name


def test_registry_counts(registries):
    port, ref = registries
    counts = {c.value: n for c, n in port.categories().items()}
    assert counts == {c.value: n for c, n in ref.categories().items()}
    assert sum(counts.values()) == 523
    assert {"filter": 47, "resampler": 10, "sync": 33, "channel": 12, "measurement": 119,
            "source": 19, "radar": 42, "math": 97, "modulator": 80, "sink": 19, "fec": 14,
            "gnss": 6, "demodulator": 25} == counts


@pytest.mark.parametrize("category", [c.value for c in RefCategory])
def test_param_schema_matches_reference(registries, category):
    port, ref = registries
    for info in ref.list(RefCategory(category)):
        got = {r["name"]: r for r in port.param_schema(info.name)}
        want = ref.param_schema(info.name)
        assert bool(got) == bool(want), info.name
        for w in want:
            g = got.get(w["name"])
            assert g is not None, (info.name, w["name"])
            assert g.get("via") == w.get("via"), info.name
            for k in SCHEMA_KEYS:
                wv = ARRAY_TYPES.get(w[k], w[k]) if k == "type" else w[k]
                if (info.name, w["name"], k) not in SCHEMA_EXEMPT:
                    assert g[k] == wv, (info.name, w["name"], k, g[k], wv)


def test_default_registry_catalog():
    """tests/test_mesh_registry.py's cases on the port."""
    reg = default_registry()
    cats = reg.categories()
    assert cats[BlockCategory.FILTER] >= 5 and cats[BlockCategory.MODULATOR] >= 40
    assert reg.get("pfb_channelizer").category == BlockCategory.RESAMPLER
    with pytest.raises(KeyError):
        reg.create("not_a_block")
    wf = reg.create("mod_qpsk", sample_rate=48_000.0, device="cpu")
    assert wf.device == torch.device("cpu") and wf.modulate(b"ok").shape[-1] > 0
    rows = {r["name"]: r for r in reg.param_schema("cfar")}
    assert rows["power"]["role"] == "input" and rows["guard"]["default"] == 2
    assert rows["pfa"]["type"] == "float" and not rows["pfa"]["required"]
    rows = {r["name"]: r for r in reg.param_schema("fir_filter")}
    assert rows["x"]["role"] == "input" and rows["taps"]["required"]


def test_key_slot_follows_reference(registries):
    """Every block whose reference function takes the key first gets a key
    from the port's pipeline, in the slot where the port's function takes
    it; no other block gets one."""
    port, ref = registries
    keyed = {}
    for info in ref.list():
        fn = info.factory()
        if callable(fn) and not isinstance(fn, type):
            keyed[info.name] = list(inspect.signature(fn).parameters)[:1] == ["key"]
    assert sorted(n for n, k in keyed.items() if k) == sorted(KEYED_CASES)  # their draws:
    # tests/test_torch_scheduler_accel.py::test_keyed_block_draws_equal_reference
    for name, want in keyed.items():
        assert (pipeline.key_slot(port.get(name).factory()) is not None) == want, name


@pytest.fixture(scope="module")
def graph16():
    payload = remote_gates.gate_payload(16)
    nodes = remote_gates.graph_nodes(payload)
    return (pipeline.run_pipeline(nodes, seed=0, sample_rate=125_000.0, device="cpu"),
            ref_pipeline.run_pipeline(nodes, seed=0, sample_rate=125_000.0), payload)


def test_block_graph_report_equals_reference(graph16):
    got, want, _ = graph16
    assert got["order"] == want["order"] == remote_gates.GRAPH_ORDER
    assert got["nodes"]["rx"]["decoded_ok"] is True
    assert {k: v["error"] for k, v in got["nodes"].items() if "error" in v} \
        == remote_gates.GRAPH_ERRORS
    verdict = remote_gates.compare_reports(got, want, power_tol=REPORT_POWER_TOL,
                                           preview_tol=REPORT_PREVIEW_TOL)
    assert verdict["equal"], verdict["diffs"]


def test_block_graph_gate_on_the_cpu():
    gate = remote_gates.block_graph_gate("cpu")
    assert gate["ok"], gate["bars"]
    again = pipeline.run_pipeline(remote_gates.graph_nodes(), seed=remote_gates.GRAPH_SEED,
                                  sample_rate=remote_gates.RATE_HZ, device="cpu")
    assert remote_gates.compare_reports(gate["report"], again, 0.0, 0.0)["equal"]  # deterministic


def test_graph_channel_node_equals_jax_on_the_same_key(graph16):
    """The `ch` node (index 1 of the order) draws the reference's noise."""
    payload = graph16[2]
    tx = create_waveform("LoRa-SF7", 125_000.0, "cpu").modulate(payload)
    key = 0 * pipeline.KEY_SEED_STRIDE + 1
    want = np.asarray(ref_channel.awgn(jax.random.key(key), tx.numpy(), 16.0))
    got = pipeline._call_block(default_registry().get("awgn_channel").factory(), [tx],
                               {"snr_db": "16"}, threefry.key(key), device="cpu")
    compare(got, want, CH_TOL, "ch")


@pytest.mark.parametrize("name", ["test_pipeline_tx_channel_filter_demod",
                                  "test_pipeline_dag_fanout_and_error_isolation",
                                  "test_pipeline_sample_rate_injection",
                                  "test_pipeline_cycle_and_dup_rejected"])
def test_reference_pipeline_cases(monkeypatch, name):
    """tests/test_pipeline_explorer.py's own cases on the port, on the CPU."""
    import test_pipeline_explorer as ref_tests

    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))
    monkeypatch.setattr(ref_tests, "run_pipeline",
                        lambda nodes, **kw: pipeline.run_pipeline(nodes, device="cpu", **kw))
    monkeypatch.setattr(ref_tests, "_topo_order", pipeline._topo_order)
    monkeypatch.setattr(ref_tests, "PipelineError", pipeline.PipelineError)
    getattr(ref_tests, name)()


def test_pipeline_block_type_error_is_the_nodes_error(monkeypatch):
    """A block that fails on tensors fails its node: it is called once and
    its inputs are not read to the host for a second call."""
    calls = []

    def numpy_only(x):
        calls.append(type(x))
        if isinstance(x, torch.Tensor):
            raise TypeError("wants a numpy array")
        return np.asarray(x) * 2

    reg = default_registry()
    monkeypatch.setattr(reg, "_blocks", dict(reg._blocks))
    reg.register("numpy_only", BlockCategory.MATH, "numpy only", lambda **k: numpy_only)
    nodes = [{"id": "src", "block": "random_source", "params": {"n": 64, "kind": "bits"}},
             {"id": "pdu", "block": "random_pdu_gen"},
             {"id": "v", "block": "vco", "params": {"sample_rate": 1000.0,
                                                    "sensitivity_hz_per_unit": 10.0},
              "inputs": ["src"]},
             {"id": "h", "block": "numpy_only", "inputs": ["src"]},
             {"id": "after", "block": "dc_blocker", "inputs": ["h"]}]
    r = pipeline.run_pipeline(nodes, device="cpu")
    assert r["nodes"]["src"]["dtype"] == "int32"
    assert r["nodes"]["v"]["dtype"] == "complex64" and r["nodes"]["v"]["shape"] == [64]
    assert "error" in r["nodes"]["pdu"]  # bytes are no array, as in the reference
    assert r["nodes"]["h"]["error"] == "TypeError: wants a numpy array" and calls == [torch.Tensor]
    assert r["nodes"]["after"]["error"] == "PipelineError: input 'h' unavailable"
    assert not r["ok"]


@pytest.fixture
def scratch_factory(monkeypatch):
    """Plugins register into copies of the factory's tables."""
    monkeypatch.setattr(wf_base, "_REGISTRY", dict(wf_base._REGISTRY))
    monkeypatch.setattr(wf_base, "_CANONICAL", list(wf_base._CANONICAL))


def test_python_plugin_load_and_factory_extension(tmp_path, scratch_factory):
    (tmp_path / "my_wave.py").write_text(textwrap.dedent("""
        R4W_PLUGIN = {"name": "my_wave", "version": "1.0", "api_version": 1,
                      "waveforms": ("MYWAVE",)}

        def register(register_waveform):
            import dataclasses, torch
            from r4w_tpu_torch.core.types import CommonParams
            from r4w_tpu_torch.waveforms.base import DemodResult, Waveform, WaveformInfo

            @dataclasses.dataclass(frozen=True)
            class MyWave(Waveform):
                device: torch.device
                common: CommonParams = CommonParams()

                @property
                def common_params(self):
                    return self.common

                def samples_per_symbol(self):
                    return 1

                def info(self):
                    return WaveformInfo(name="MYWAVE", full_name="test")

                def modulate(self, data):
                    return torch.ones(8, dtype=torch.complex64, device=self.device)

                def demodulate(self, samples):
                    z = torch.zeros(0, dtype=torch.int32, device=self.device)
                    return DemodResult(bits=z, symbols=z)

            @register_waveform("MYWAVE")
            def _build(sample_rate, device):
                return MyWave(device, CommonParams(sample_rate=sample_rate))
    """))
    (tmp_path / "bad.py").write_text('R4W_PLUGIN = {"name": "bad", "version": "1", '
                                     '"api_version": 99}\ndef register(r):\n    pass\n')
    pm = PluginManager(search_paths=(str(tmp_path),))
    assert len(pm.discover_plugins()) == 2
    infos = pm.load_all()
    assert [i.name for i in infos] == ["my_wave"] and "api_version" in pm.errors["bad"]
    assert create_waveform("MYWAVE", device="cpu").modulate(b"").shape == (8,)
    assert list_waveforms()[-1] == "MYWAVE"


def _gxx(out: Path, src: Path, *include) -> None:
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", *[f"-I{p}" for p in include], "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=120)


def test_native_plugin_load_and_roundtrip(tmp_path, scratch_factory):
    """The shipped example plugin, built from the port's copy, through the
    C-ABI path and the factory; the bits come back as a tensor."""
    src = REPO / "r4w_tpu_torch" / "native"
    so = tmp_path / "libr4w_example_plugin.so"
    _gxx(so, src / "example_plugin.cpp", src)
    pm = PluginManager(search_paths=[str(tmp_path)])
    info = pm.load_native_plugin(str(so))
    assert info is not None, pm.errors
    assert (info.name, info.waveforms) == ("example-native", ("manchester-ook",))
    wf = create_waveform("manchester-ook", 125_000.0, "cpu")
    payload = bytes([0xC3, 0x5A, 0x0F])
    tx = wf.modulate(payload)
    assert tx.shape == (3 * 8 * 2 * 8,) and tx.dtype == torch.complex64
    res = wf.demodulate(tx)
    assert isinstance(res.bits, torch.Tensor) and res.bits[:3].tolist() == list(payload)


def test_native_plugin_api_version_rejected(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text('#include <cstdint>\n'
                   'extern "C" uint32_t r4w_plugin_api_version() { return 99; }\n')
    so = tmp_path / "libbad.so"
    _gxx(so, bad)
    pm = PluginManager(search_paths=[str(tmp_path)])
    assert pm.load_native_plugin(str(so)) is None
    assert "api_version" in list(pm.errors.values())[0]


def test_plugin_search_path_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("R4W_TPU_TORCH_PLUGIN_PATH", str(tmp_path))
    assert os.path.expanduser(str(tmp_path)) in PluginManager().search_paths
    assert "jax" not in sys.modules["r4w_tpu_torch.registry"].__dict__
