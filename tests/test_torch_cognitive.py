"""`ops.cognitive` against the JAX package.

The cognitive half of tests/test_cognitive_propagation.py and the
cognitive cases of the known-answer files run on the port through
`torch_port_proxy`. Parity cases hold each signal-facing function against
the reference on the same numpy inputs: decisions (busy masks, the CSMA
slot and rounds, mask compliance) equal, floats within TOL of the largest
reference magnitude (FFTs and sums in another order), LOOP_TOL for the
100-step power-control loop. The leading-rows form of the sensing
functions gives, row by row, the reference's call on that row; the CSMA
trace draws the reference's own threefry uniforms, so slot and rounds are
equal on every timeline tried.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import cognitive as ref
from r4w_tpu_torch.ops import cognitive as cg
from torch_port_proxy import check_parity, compare, run_reference_test

TOL = 1e-5
LOOP_TOL = 1e-4   # 100 float32 steps of (L × L) products in another order

CG = "r4w_tpu_torch.ops.cognitive"
CG_REF = {"r4w_tpu.ops.cognitive": CG}

REFERENCE_TESTS = [
    *[("test_cognitive_propagation", n, {}, {"cg": CG}) for n in (
        "TestSpectrumMgmt.test_channel_occupancy", "TestSpectrumMgmt.test_broker_grants_cleanest",
        "TestSpectrumMgmt.test_learner_prefers_idle", "TestSpectrumMgmt.test_cognitive_engine_step",
        "TestSpectrumMgmt.test_coexistence_report", "TestInterference.test_classifier_kinds",
        "TestInterference.test_excision_removes_tone_keeps_signal",
        "TestLinkAdapt.test_mcs_ladder_monotone", "TestLinkAdapt.test_carrier_aggregation",
        "TestLinkAdapt.test_power_control_converges_to_target",
        "TestLinkAdapt.test_timing_advance", "TestMac.test_lorawan_duty_cycle",
        "TestMac.test_csma_waits_for_idle", "TestMac.test_waveform_diversity",
        "TestMac.test_rf_router", "TestMasksLpi.test_spectral_mask_and_compliance",
        "TestMasksLpi.test_lpi_metrics_rank_signals")],
    *[("test_known_answers_r4j", n, CG_REF, {}) for n in (
        "TestPowerControl.test_step_command_signs",
        "TestPowerControl.test_converges_to_linear_system_fixed_point")],
    ("test_known_answers_r4p", "TestSpectralMask.test_piecewise_linear_interpolation", CG_REF, {}),
    ("test_known_answers_r4q", "TestTimingAdvance.test_offset_to_distance", CG_REF, {}),
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    run_reference_test(monkeypatch, module, name, modules, **swaps)


def _cplx(rng, *shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(
        np.complex64)


def _band(rng, n=1 << 15):
    """Unit noise, a strong carrier on channels 2-3 and a weak tone in
    channel 9 of 16 over the fftshifted band."""
    t = np.arange(n)
    x = _cplx(rng, n)
    x += 4.0 * np.exp(2j * np.pi * (-0.5 + 2.7 / 16) * t).astype(np.complex64)
    x[n // 3:] += 0.8 * np.exp(2j * np.pi * (-0.5 + 9.5 / 16) * t[n // 3:]).astype(np.complex64)
    return x


def _lpi(fn):
    return lambda x: [fn(x)[k] for k in ("envelope_kurtosis", "psd_peak_avg_db",
                                         "spectral_entropy")]


def _cases():
    r = np.random.default_rng(16)
    band = _band(r)
    spread = (2.0 * r.integers(0, 2, 8192) - 1.0).astype(np.complex64)
    jammed = spread + (5.0 * np.exp(2j * np.pi * 0.21 * np.arange(8192))).astype(np.complex64)
    gains = np.array([[1.0, 0.08, 0.05], [0.1, 0.9, 0.07], [0.02, 0.06, 1.1]], np.float32)
    mask = [(0.0, 0.0), (1e6, -20.0), (5e6, -60.0)]
    freqs = np.linspace(-6e6, 6e6, 101).astype(np.float32)
    psd = (-25.0 - 5e-6 * np.abs(freqs)).astype(np.float32)
    return [
        ("channel_occupancy", lambda x: cg.channel_occupancy(x, 16),
         lambda x: ref.channel_occupancy(x, 16), (band,), TOL),
        ("channel_occupancy_256", lambda x: cg.channel_occupancy(x, 8, 256, 3.0),
         lambda x: ref.channel_occupancy(x, 8, 256, 3.0), (band[:5000],), TOL),
        ("coexistence_report", cg.coexistence_report, ref.coexistence_report, (band,), TOL),
        ("interference_excise", cg.interference_excise, ref.interference_excise,
         (jammed[:8000],), TOL),
        ("power_control", lambda g, nz: (cg.power_control_converge(g, nz, 8.0),
                                         cg.power_control_step(torch.tensor([3.0, 9.0]), 8.0)),
         lambda g, nz: (ref.power_control_converge(g, nz, 8.0),
                        ref.power_control_step(jnp.asarray([3.0, 9.0]), 8.0)),
         (gains, np.float32([0.01, 0.02, 0.01])), LOOP_TOL),
        ("spectral_mask", lambda f: cg.spectral_mask(f, mask), lambda f: ref.spectral_mask(f, mask),
         (freqs,), TOL),
        ("mask_compliance", lambda p, f: cg.mask_compliance(p, f, mask),
         lambda p, f: ref.mask_compliance(p, f, mask), (psd, freqs), TOL),
        ("lpi_metrics", _lpi(cg.lpi_metrics), _lpi(ref.lpi_metrics), (band[:16384],), TOL),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,port,want,args,tol", CASES, ids=[c[0] for c in CASES])
def test_parity(name, port, want, args, tol):
    check_parity(port, want, args, tol=tol, label=name)


def test_sensing_rows_are_blocks():
    """(rows, n): each row's frames kept apart, each row the reference's
    call on that block."""
    r = np.random.default_rng(4)
    rows = np.stack([_band(r, 8192), _cplx(r, 8192), _band(r, 8192)])
    got = [cg.channel_occupancy(torch.from_numpy(rows), 16), cg.coexistence_report(
        torch.from_numpy(rows)), (cg.interference_excise(torch.from_numpy(rows), 4.0, 1024),)]
    for k in range(rows.shape[0]):
        x = jnp.asarray(rows[k])
        want = [ref.channel_occupancy(x, 16), ref.coexistence_report(x),
                (ref.interference_excise(x, 4.0, 1024),)]
        for g, w in zip(got, want):
            compare([v[k] for v in g], w, TOL)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_csma_trace_draws_the_reference_uniforms(seed):
    """The threefry uniforms of `PRNGKey(seed)`: the success slot and the
    rounds equal the reference's on timelines busy at the start, in bursts
    and all through."""
    r = np.random.default_rng(seed)
    for busy in (np.arange(120) < 50, r.random(200) < 0.6, np.ones(40, bool)):
        got = cg.csma_backoff_trace(torch.from_numpy(busy), 4, 64, seed)
        want = ref.csma_backoff_trace(jnp.asarray(busy), 4, 64, seed)
        assert [int(v) for v in got] == [int(v) for v in want]


def test_host_control_plane_is_the_reference():
    """Broker, learner, engine, link adaptation and the MAC schedulers."""
    r = np.random.default_rng(6)
    band = _band(r)
    occ = r.standard_normal(8).astype(np.float32)
    a, b = cg.SpectrumBroker(8), ref.SpectrumBroker(8)
    assert [a.request(u, torch.from_numpy(occ)) for u in "xyz"] == [b.request(u, occ)
                                                                   for u in "xyz"]
    e, f = cg.CognitiveEngine(16), ref.CognitiveEngine(16)
    for snr in (1.0, 11.0, 23.0):
        got, want = e.step(torch.from_numpy(band), snr), f.step(jnp.asarray(band), snr)
        assert (got["channel"], got["mcs"]) == (want["channel"], want["mcs"])
        np.testing.assert_array_equal(got["busy"], np.asarray(want["busy"]))
    np.testing.assert_array_equal(e.learner.p_idle, f.learner.p_idle)
    assert [cg.link_adapt(s, 2.0, 3) for s in range(-4, 26)] == [
        ref.link_adapt(s, 2.0, 3) for s in range(-4, 26)]
    assert cg.carrier_aggregation_schedule(torch.tensor([3.0, 18.0, 9.0, 25.0]),
                                           {"a": 4000, "b": 900}) == \
        ref.carrier_aggregation_schedule([3.0, 18.0, 9.0, 25.0], {"a": 4000, "b": 900})
    assert cg.lorawan_schedule({"d": 0.37}, 0.01, 500.0) == ref.lorawan_schedule(
        {"d": 0.37}, 0.01, 500.0)
    assert cg.interference_classify(torch.from_numpy(band[:4096]), 1e6) == \
        ref.interference_classify(band[:4096], 1e6)
