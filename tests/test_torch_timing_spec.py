"""`timing` and `waveform_spec` against the JAX package.

The five timing tests of tests/test_timing_sandbox.py and both spec tests
of tests/test_hal_specs.py run on the port through `torch_port_proxy`.
The trap tests: `Timestamp.from_samples` rounds n·10¹²/fs once in float64,
so its picoseconds equal the reference's exactly (the hopping gate's
h·81,920 samples at 2.048 MS/s are h·4·10¹⁰ ps); `WaveformSpec.load`
parses a path that does not resolve as YAML text and fails as the
reference does; the gate's 16-QAM spec dict equals ``yaml.safe_load`` of
specs/qam16.yaml and builds the same spec field by field; the spec
waveform's samples, decisions and bits equal the reference's.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from r4w_tpu import timing as ref_tm
from r4w_tpu import waveform_spec as ref_ws
from r4w_tpu.waveform_spec import WaveformSpec as RefSpec
from r4w_tpu_torch import hop_gates as hg
from r4w_tpu_torch import timing as tm
from r4w_tpu_torch import waveforms as port_waveforms
from r4w_tpu_torch.waveform_spec import WaveformSpec, load_spec_dir
from torch_port_proxy import run_reference_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(REPO, "specs")


def create_waveform(name: str, sample_rate: float = 125_000.0):
    """The port's factory on the CPU, for the reference's spec test (the
    factory's default device is the card, bound when it was defined)."""
    return port_waveforms.create_waveform(name, sample_rate, "cpu")


REFERENCE_TESTS = [
    *[("test_timing_sandbox", n, {}, {"tm": "r4w_tpu_torch.timing"}) for n in (
        "test_timestamp_exact_arithmetic", "test_timestamp_sample_conversion",
        "test_sample_clock", "test_wall_clock_pause_and_scale", "test_hardware_clock_drift")],
    *[("test_hal_specs", n, {"r4w_tpu.waveform_spec": "r4w_tpu_torch.waveform_spec",
                             "r4w_tpu.waveforms": "test_torch_timing_spec"}, {}) for n in (
        "test_spec_assets_load_and_validate", "test_spec_builds_runnable_waveform")],
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    monkeypatch.chdir(REPO)   # the spec tests read specs/ by a relative path
    run_reference_test(monkeypatch, module, name, modules, **swaps)


@pytest.mark.parametrize("n,rate", [(h * hg.PERIOD, hg.CAPTURE_RATE_HZ) for h in (0, 1, 3, 249)]
                         + [(48_000_000, 48e6), (1, 3e6), (7, 2.4e6), (10**9 + 7, 30.72e6),
                            (123_456_789, 44_100.0)])
def test_timestamp_picoseconds_exact(n, rate):
    got, want = tm.Timestamp.from_samples(n, rate), ref_tm.Timestamp.from_samples(n, rate)
    assert (got.secs, got.picos) == (want.secs, want.picos)
    assert got.to_samples(rate) == want.to_samples(rate)
    if rate == hg.CAPTURE_RATE_HZ:
        assert got.secs * tm.Timestamp.PICOS_PER_SEC + got.picos == n // hg.PERIOD * 40 * 10**9


def test_timestamp_arithmetic_equals_reference():
    a, b = tm.Timestamp.from_seconds(12.345678901234), tm.Timestamp.from_seconds(0.987654321)
    ra, rb = ref_tm.Timestamp.from_seconds(12.345678901234), ref_tm.Timestamp.from_seconds(
        0.987654321)
    for got, want in ((a + b, ra + rb), (a - b, ra - rb), (b - a, rb - ra)):
        assert (got.secs, got.picos) == (want.secs, want.picos)


def test_hardware_clock_jitter_equals_reference():
    got, want = tm.HardwareClock(2e6, 5.0, 20.0, seed=3), ref_tm.HardwareClock(2e6, 5.0, 20.0, 3)
    for n in (1, 1000, 2_000_000):
        got.advance(n)
        want.advance(n)
        assert got.apparent_time() == want.apparent_time()
        assert got.offset() == want.offset()


def test_gate_spec_dict_is_the_yaml():
    with open(os.path.join(SPECS, "qam16.yaml")) as f:
        doc = [d for d in yaml.safe_load_all(f) if d][0]
    assert hg.QAM16_SPEC == doc


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(SPECS) if f.endswith(".yaml")))
def test_spec_fields_equal_reference(name):
    path = os.path.join(SPECS, name)
    got, want = WaveformSpec.load(path), RefSpec.load(path)
    for field in ("name", "full_name", "description", "scheme", "order", "bits_per_symbol",
                  "gray_coded", "differential", "pulse_type", "rolloff", "span_symbols",
                  "symbol_rate", "sample_rate", "samples_per_symbol", "raw"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.constellation, want.constellation)
    if name == "qam16.yaml":
        built = hg.spec()
        for field in ("name", "order", "bits_per_symbol", "samples_per_symbol", "sample_rate",
                      "symbol_rate", "raw"):
            assert getattr(built, field) == getattr(want, field), field
        np.testing.assert_array_equal(built.constellation, want.constellation)


def test_load_spec_dir_equals_reference():
    got, want = load_spec_dir(SPECS), ref_ws.load_spec_dir(SPECS)
    assert sorted(got) == sorted(want)


def test_missing_relative_path_is_parsed_as_text(monkeypatch, tmp_path):
    # the reference reads a path that does not resolve as YAML text: a one-line
    # string, whose .get fails; the port keeps the rule
    monkeypatch.chdir(tmp_path)
    for cls in (WaveformSpec, RefSpec):
        with pytest.raises(AttributeError, match="'str' object has no attribute 'get'"):
            cls.load("specs/qam16.yaml")
    assert WaveformSpec.load(os.path.join(SPECS, "qam16.yaml")).name == "16-QAM"


@pytest.mark.parametrize("name", ["qam16", "qpsk", "bpsk"])
def test_spec_waveform_equals_reference(name):
    path = os.path.join(SPECS, f"{name}.yaml")
    wf, ref = WaveformSpec.load(path).build_waveform("cpu"), RefSpec.load(path).build_waveform()
    data = bytes(np.random.default_rng(7).integers(0, 256, 40, dtype=np.uint8))
    tx, ref_tx = wf.modulate(data), np.asarray(ref.modulate(data))
    np.testing.assert_array_equal(tx.numpy(), ref_tx)
    noisy = (ref_tx + 0.2 * np.random.default_rng(8).standard_normal(ref_tx.shape)).astype(
        np.complex64)
    got, want = wf.demodulate(torch.from_numpy(noisy)), ref.demodulate(noisy)
    np.testing.assert_array_equal(got.symbols.numpy(), np.asarray(want.symbols))
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert abs(got.snr_estimate - want.snr_estimate) < 1e-4
    assert wf.samples_per_symbol() == ref.samples_per_symbol()
    assert wf.info().name == ref.info().name
    np.testing.assert_array_equal(wf.constellation_points().numpy(),
                                  np.asarray(ref.constellation_points()))


def test_spec_module_imports_yaml_only_in_load():
    import ast
    import inspect

    from r4w_tpu_torch import waveform_spec
    tree = ast.parse(inspect.getsource(waveform_spec))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("yaml" in ast.dump(n) for n in top)
