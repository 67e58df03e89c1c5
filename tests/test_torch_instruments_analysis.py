"""`ops.instruments` and `analysis` against the JAX package.

The instrument classes of tests/test_bio_nav_instruments.py, the
spectrum-analyser tests of tests/test_mesh_registry.py and the instrument
cases of the known-answer files run on the port through
`torch_port_proxy`. Parity cases hold each function against the reference
on the same numpy inputs: decisions and indices equal, floats within TOL
of the largest reference magnitude (FFTs and sums in another order),
SOLVE_TOL for the float32 2 × 2 triangulation solve. `spur_scan` ranks by
a stable descending sort: tied spur powers keep the lower bin first, as
``lax.top_k``. The analysers' numpy views (peak table, bandwidths,
renderings) equal the reference's on the same spectrum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu import analysis as ref_analysis
from r4w_tpu.ops import instruments as ref
from r4w_tpu_torch import analysis
from r4w_tpu_torch.core import types
from r4w_tpu_torch.ops import instruments as inst
from torch_port_proxy import check_parity, compare, run_reference_test

TOL = 1e-5
SOLVE_TOL = 1e-4   # the float32 normal equations of the bearing lines
PSD_TOL = 1e-5     # the analysers' dB views as power, relative to the largest

INST = "r4w_tpu_torch.ops.instruments"
INST_REF = {"r4w_tpu.ops.instruments": INST}

REFERENCE_TESTS = [
    *[("test_bio_nav_instruments", n, {}, {"inst": INST}) for n in (
        "TestInstruments.test_s21_of_known_filter", "TestInstruments.test_scope_trigger_alignment",
        "TestInstruments.test_jitter_analyzer", "TestInstruments.test_power_meter",
        "TestInstruments.test_vsa_report", "TestRfCircuits.test_quarter_wave_transform",
        "TestRfCircuits.test_stub_match_improves_vswr", "TestRfCircuits.test_microstrip_z0_monotone",
        "TestRfCircuits.test_dipole_resonance", "TestRfCircuits.test_iq_calibrator_fixes_imbalance",
        "TestEmc.test_pim_frequencies_and_level", "TestEmc.test_emi_scan_finds_emission",
        "TestEmc.test_injection_locking", "TestEmc.test_spur_scan_and_cancel",
        "TestDf.test_watson_watt_bearing", "TestDf.test_triangulation",
        "TestDf.test_gps_spoof_detector", "TestFingerprint.test_modulation_fingerprint_separates",
        "TestFingerprint.test_rf_device_fingerprint_stable",
        "TestFingerprint.test_environment_map_peak_near_strong_node",
        "TestFingerprint.test_protocol_anomaly", "TestFingerprint.test_radiometer_and_correlator")],
    ("test_known_answers_r4j", "TestEmcRadiatedImmunity.test_levels_match_iec_61000_4_3",
     INST_REF, {}),
    ("test_known_answers_r4o", "TestJitterAnalyzer.test_known_tie_statistics", INST_REF, {}),
    *[("test_known_answers_r4p", n, INST_REF, {}) for n in (
        "TestNetworkAnalyzerS21.test_matches_filter_frequency_response",
        "TestOscilloscopeTrigger.test_crossing_indices_and_alignment")],
    ("test_known_answers_r4t", "TestRadiometer.test_total_power_and_cross_correlation", INST_REF,
     {}),
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    run_reference_test(monkeypatch, module, name, modules, **swaps)


@pytest.mark.parametrize("bearing_deg", [0.0, 50.0, 200.0, 315.0])
def test_reference_direction_finder_on_port(monkeypatch, bearing_deg):
    run_reference_test(monkeypatch, "test_known_answers_r4j",
                       "TestRadioDirectionFinder.test_recovers_constructed_bearing", INST_REF,
                       params={"bearing_deg": bearing_deg})


@pytest.mark.parametrize("name", ["test_spectrum_analyzer_two_tones", "test_waterfall_shows_sweep"])
def test_reference_analysis_test_on_port(monkeypatch, name):
    """The analysers run on the port's measure functions, their numpy views
    read by the reference test unchanged."""
    import test_mesh_registry

    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))
    monkeypatch.setattr(test_mesh_registry, "analysis", analysis)
    getattr(test_mesh_registry, name)()


def _cplx(rng, *shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(
        np.complex64)


def _values(fn, *keys):
    return lambda *a: [fn(*a)[k] for k in keys]


QPSK = (np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))) * 1.0).astype(np.complex64)


def _cases():
    r = np.random.default_rng(16)
    fs = 1e6
    t = np.arange(8192) / fs
    two_tone = (np.exp(2j * np.pi * 100e3 * t) + 1e-3 * np.exp(2j * np.pi * -230e3 * t)
                + 0.001 * _cplx(r, 8192)).astype(np.complex64)
    syms = QPSK[r.integers(0, 4, 2000)] + 0.05 * _cplx(r, 2000)
    scope = np.sin(2 * np.pi * 0.013 * np.arange(3000)).astype(np.float32)
    edges = (np.arange(200) * 1e-6 + 2e-9 * r.standard_normal(200)).astype(np.float32)
    iq = _cplx(r, 4096)
    iq = (iq.real + 1j * (1.2 * iq.imag + 0.1 * iq.real)).astype(np.complex64)
    emi = (np.sin(2 * np.pi * 150e3 * np.arange(20000) / 2e6) + 0.01 * r.standard_normal(20000))
    locked = (np.exp(2j * np.pi * 1234.0 * np.arange(4096) / 48e3) + 0.05 * _cplx(r, 4096)).astype(
        np.complex64)
    chirp = np.exp(1j * np.pi * np.arange(4096) ** 2 / 4096).astype(np.complex64)
    ns, ew = np.cos(np.deg2rad(35.0)), np.sin(np.deg2rad(35.0))
    carrier = np.sin(2 * np.pi * 0.01 * np.arange(1024)).astype(np.float32)
    st = np.float32([[0, 0], [1000, 0], [0, 1000]])
    bearings = np.float32([45.0, 315.0, 135.0])
    pd = np.exp(1j * 0.3 * np.cos(2 * np.pi * 500 * np.arange(8000) / 48e3 - 1.1)).astype(
        np.complex64)
    return [
        ("network_analyzer_s21", inst.network_analyzer_s21, ref.network_analyzer_s21,
         (chirp, np.convolve(chirp, [1.0, 0.5, 0.2])[:4096].astype(np.complex64)), TOL),
        ("oscilloscope_trigger", lambda x: inst.oscilloscope_trigger(x, 0.5, holdoff=40),
         lambda x: ref.oscilloscope_trigger(x, 0.5, holdoff=40), (scope,), 0.0),
        ("oscilloscope_trigger_falling", lambda x: inst.oscilloscope_trigger(
            x, -0.2, "falling", 10, 4, 32, 8), lambda x: ref.oscilloscope_trigger(
            x, -0.2, "falling", 10, 4, 32, 8), (scope[:900],), 0.0),
        ("jitter_analyze", _values(lambda e: inst.jitter_analyze(e, 1e-6), "tie", "tie_pp_s",
                                   "tie_rms_s", "period_jitter_rms_s"),
         _values(lambda e: ref.jitter_analyze(e, 1e-6), "tie", "tie_pp_s", "tie_rms_s",
                 "period_jitter_rms_s"), (edges,), TOL),
        ("power_meter_dbm", inst.power_meter_dbm, ref.power_meter_dbm, (syms,), TOL),
        ("vector_signal_analyze", _values(lambda x: inst.vector_signal_analyze(x, QPSK),
                                          "evm_rms", "decision_margin", "mag_error",
                                          "phase_error_rad", "papr_db", "snr_est_db"),
         _values(lambda x: ref.vector_signal_analyze(x, QPSK), "evm_rms", "decision_margin",
                 "mag_error", "phase_error_rad", "papr_db", "snr_est_db"), (syms,), TOL),
        ("iq_impairment_calibrate", lambda x: (inst.iq_impairment_calibrate(x)[0],
                                               inst.iq_impairment_calibrate(x)[1]["gain"]),
         lambda x: (ref.iq_impairment_calibrate(x)[0], ref.iq_impairment_calibrate(x)[1]["gain"]),
         (iq,), TOL),
        ("pim_level", lambda x: inst.pim_level(x, 100e3, 130e3, fs),
         lambda x: ref.pim_level(x, 100e3, 130e3, fs), (two_tone,), TOL),
        ("emi_conducted_scan", lambda x: inst.emi_conducted_scan(x, 2e6),
         lambda x: ref.emi_conducted_scan(x, 2e6), (emi,), TOL),
        ("injection_locking_detect", lambda x: inst.injection_locking_detect(x, 48e3, 1000.0),
         lambda x: ref.injection_locking_detect(x, 48e3, 1000.0), (locked,), TOL),
        ("spur_scan", lambda x: inst.spur_scan(x, fs, 100e3, threshold_dbc=-80.0),
         lambda x: ref.spur_scan(x, fs, 100e3, threshold_dbc=-80.0), (two_tone,), TOL),
        ("spur_cancel", lambda x: inst.spur_cancel(x, [-230e3], fs),
         lambda x: ref.spur_cancel(x, [-230e3], fs), (two_tone,), TOL),
        ("watson_watt_bearing", lambda c: inst.watson_watt_bearing(ns * c, ew * c, -c),
         lambda c: ref.watson_watt_bearing(ns * c, ew * c, -c), (carrier,), TOL),
        ("df_bearing_pseudodoppler", lambda x: inst.df_bearing_pseudodoppler(x, 48e3, 500.0),
         lambda x: ref.df_bearing_pseudodoppler(x, 48e3, 500.0), (pd,), TOL),
        ("triangulate_bearings", inst.triangulate_bearings, ref.triangulate_bearings,
         (st, bearings), SOLVE_TOL),
        ("modulation_fingerprint", inst.modulation_fingerprint, ref.modulation_fingerprint,
         (syms,), TOL),
        ("rf_device_fingerprint", inst.rf_device_fingerprint, ref.rf_device_fingerprint,
         (iq,), TOL),
        ("rf_environment_map", lambda p, xy: inst.rf_environment_map(p, xy, 16, 50.0),
         lambda p, xy: ref.rf_environment_map(p, xy, 16, 50.0),
         (np.float32([-40.0, -70.0, -55.0]), np.float32([[10, 20], [-30, 5], [0, -40]])), TOL),
        ("protocol_anomaly_score", inst.protocol_anomaly_score, ref.protocol_anomaly_score,
         (r.integers(60, 80, 50).astype(np.float32), r.exponential(1.0, 50).astype(np.float32)),
         TOL),
        ("radiometer_total_power", inst.radiometer_total_power, ref.radiometer_total_power,
         (iq,), TOL),
        ("telescope_cross_correlate", lambda a, b: inst.telescope_cross_correlate(a, b, 16),
         lambda a, b: ref.telescope_cross_correlate(a, b, 16), (iq[:1000], np.roll(iq[:1000], 5)),
         TOL),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,port,want,args,tol", CASES, ids=[c[0] for c in CASES])
def test_parity(name, port, want, args, tol):
    check_parity(port, want, args, tol=tol, label=name)


def test_spur_ranking_ties_keep_the_lower_bin_first():
    """`spur_scan` ranks by `top_k`, a stable descending sort: among tied
    powers the lower bin comes first, as ``lax.top_k`` on the same values
    (exact ties, zeros of the exclusion among them); then a scan with two
    pairs of spurs of one level, which agrees with the reference's."""
    import jax

    r = np.random.default_rng(11)
    for _ in range(20):
        v = r.integers(0, 5, 64).astype(np.float32)
        got_v, got_i = inst.top_k(torch.from_numpy(v), 12)
        want_v, want_i = jax.lax.top_k(jnp.asarray(v), 12)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    n = 1024
    t = np.arange(n)
    x = np.exp(2j * np.pi * 0.25 * t)
    for b in (100, 200, -100, -200):
        x = x + 1e-2 * np.exp(2j * np.pi * b / n * t)
    x = x.astype(np.complex64)
    got = inst.spur_scan(torch.from_numpy(x), float(n), 256.0, exclude_hz=10.0, max_spurs=4)
    want = ref.spur_scan(jnp.asarray(x), float(n), 256.0, exclude_hz=10.0, max_spurs=4)
    assert sorted(got[0].tolist()) == sorted(np.asarray(want[0]).tolist())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_rf_circuits_are_the_reference_numpy():
    assert inst.stub_match(25 - 40j) == ref.stub_match(25 - 40j)
    assert inst.microstrip_impedance(0.5) == ref.microstrip_impedance(0.5)
    assert inst.dipole_optimize(433e6) == ref.dipole_optimize(433e6)
    assert inst.pim_products(900e6, 905e6, 5) == ref.pim_products(900e6, 905e6, 5)
    assert inst.gps_spoof_detect(np.full(8, 48.0), np.full(8, 10.0), 2e-6) == \
        ref.gps_spoof_detect(np.full(8, 48.0), np.full(8, 10.0), 2e-6)
    compare(inst.immunity_test_levels(torch.tensor([80e6, 1e9]), 10.0),
            ref.immunity_test_levels([80e6, 1e9], 10.0), 0.0)


def test_analysers_against_the_reference():
    """`SpectrumAnalyzer` and `Waterfall`: the PSD and the waterfall as
    power within PSD_TOL of the largest (in dB, bins far under the peak
    carry the FFTs' rounding), the peak table and bandwidths equal."""
    r = np.random.default_rng(8)
    fs = 200e3
    t = np.arange(16384) / fs
    x = (np.exp(2j * np.pi * 31e3 * t) + 0.2 * np.exp(-2j * np.pi * 50e3 * t)
         + 0.01 * _cplx(r, t.size)).astype(np.complex64)
    got = analysis.SpectrumAnalyzer(fs, 512).compute(torch.from_numpy(x), 3)
    want = ref_analysis.SpectrumAnalyzer(fs, 512).compute(x, 3)
    compare(10.0 ** (got.psd_db / 10.0), 10.0 ** (want.psd_db / 10.0), PSD_TOL)
    assert [p.bin for p in got.peaks] == [p.bin for p in want.peaks]
    assert (got.bandwidth_3db_hz, got.occupied_bandwidth_hz) == (
        want.bandwidth_3db_hz, want.occupied_bandwidth_hz)
    assert abs(got.total_power_db - want.total_power_db) < 1e-5
    wf = analysis.Waterfall(fs, 128, 128)
    compare(10.0 ** (wf.compute(torch.from_numpy(x)) / 10.0),
            10.0 ** (ref_analysis.Waterfall(fs, 128, 128).compute(x) / 10.0), PSD_TOL)
    assert wf.to_ascii(torch.from_numpy(x)).count("\n") > 4
