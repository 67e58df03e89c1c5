"""`ops.applied` and `adsb` against the JAX package.

tests/test_applied.py, the ADS-B half of tests/test_adsb_ephemeris.py and
the applied and ADS-B cases of the known-answer files run on the port
through `torch_port_proxy` (the wavelet and LPC-vocoder tests too, which
the reference marks slow). Parity cases hold every applied function against
the reference on the same numpy inputs: decisions (cepstral and OMP
supports, labels) equal, floats within TOL of the largest reference
magnitude (FFTs and sums in another order), LOOP_TOL for the Levinson and
all-pole loops and for FastICA's 64 iterations, SOLVE_TOL for the float32
2 × 2 trilateration solve and OMP's Gram solves (LAPACK against XLA's
solver). FastICA is held by each separated source's correlation with the
truth too. The trap tests: the NaN-median of an even count of values
averages the two middle ones, and OMP's support is the reference's.
ADS-B frames are host numpy on the port's CRC: bits equal.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu import adsb as ref_adsb
from r4w_tpu.ops import applied as ref
from r4w_tpu_torch import adsb
from r4w_tpu_torch.ops import applied as ap
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5
LOOP_TOL = 1e-4
SOLVE_TOL = 1e-4

AP = "r4w_tpu_torch.ops.applied"
ADSB = "r4w_tpu_torch.adsb"
KA = {"r4w_tpu.ops.applied": AP, "r4w_tpu.adsb": ADSB}

REFERENCE_TESTS = [
    *[("test_applied", n, {}, {"ap": AP}, {}) for n in (
        "TestDenoise.test_spectral_subtraction_improves_snr",
        "TestDenoise.test_wavelet_denoise_improves_snr", "TestSpeech.test_cepstral_pitch",
        "TestSpeech.test_lpc_whitens_ar_process", "TestSpeech.test_lpc_vocoder_roundtrip",
        "TestVibration.test_bearing_fault_detection", "TestLocalization.test_trilateration_exact",
        "TestLocalization.test_trilateration_noisy", "TestSeparation.test_fastica_unmixes_two_sources",
        "TestCompressiveSensing.test_omp_recovers_sparse_vector",
        "TestModulationClassifier.test_classifies_linear_schemes",
        "TestModulationClassifier.test_classifies_fm_like")],
    *[("test_adsb_ephemeris", n, {}, {"adsb": ADSB}, {}) for n in (
        "test_adsb_identification_roundtrip", "test_adsb_altitude_roundtrip",
        "test_adsb_crc_detects_bit_error", "test_adsb_over_ppm_waveform",
        "test_adsb_rejects_non_df17")],
    *[("test_known_answers_families", n, KA, {}, {}) for n in (
        "test_adsb_canonical_identification_frame", "test_adsb_canonical_airborne_position_frame",
        "test_adsb_crc_rejects_corruption")],
    *[("test_known_answers_r4k", f"TestEchoCepstrumSeries.{n}", KA, {}, {}) for n in (
        "test_echo_quefrency_amplitudes", "test_missing_fundamental_pitch")],
    ("test_known_answers_r4m", "TestOmp.test_exact_sparse_recovery", KA, {}, {}),
    ("test_known_answers_r4n", "TestTrilateration.test_exact_2d_position", KA, {}, {}),
    ("test_known_answers_r4n", "TestWaveletDenoise.test_noise_suppressed_clean_preserved", KA,
     {}, {}),
    ("test_known_answers_r4n", "TestSpectralSubtraction.test_snr_improves_with_noise_lead_in", KA,
     {}, {}),
    ("test_known_answers_r4o", "TestLpcOnArProcess.test_recovers_ar2_prediction_filter", KA, {},
     {}),
    ("test_known_answers_r4q", "TestEnvelopeSpectrum.test_fault_line_appears_at_modulation_rate",
     KA, {}, {}),
    ("test_known_answers_r4t", "TestModulationCumulants.test_published_cumulant_values", KA, {},
     {}),
]


@pytest.mark.parametrize("module,name,modules,swaps,params", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps, params):
    run_reference_test(monkeypatch, module, name, modules, params=params, **swaps)


def _ar(rng, n=4096):
    e = rng.standard_normal(n)
    x = np.zeros(n)
    for i in range(2, n):
        x[i] = 1.2 * x[i - 1] - 0.7 * x[i - 2] + e[i]
    return x.astype(np.float32)


def _features(f):
    return lambda x: [f(x)[k] for k in ("abs_c20", "abs_c40", "abs_c42", "abs_m80", "env_var")]


def _cases():
    r = np.random.default_rng(17)
    t = np.arange(16384)
    tone = np.sin(2 * np.pi * 0.03 * t).astype(np.float32)
    noise = 0.5 * r.standard_normal(16384).astype(np.float32)
    noisy = np.concatenate([noise[:2048], (tone + noise)[2048:]])
    fs = 8000.0
    ts = np.arange(4096) / fs
    voiced = (sum(np.sin(2 * np.pi * 147.0 * k * ts) / k for k in range(1, 6))
              + 0.05 * r.standard_normal(4096)).astype(np.float32)
    tv = np.arange(20000) / 1e4
    vib = ((1 + 0.8 * (np.cos(2 * np.pi * 87 * tv) > 0.95)) * np.sin(2 * np.pi * 3200 * tv)
           + 0.3 * r.standard_normal(tv.size)).astype(np.float32)
    anchors = r.uniform(0, 1000, (6, 2))
    ranges = np.linalg.norm(anchors - [400.0, 300.0], axis=1) + r.normal(0, 1.0, 6)
    s1, s2 = np.sign(r.standard_normal(8000)), r.uniform(-1.7, 1.7, 8000)
    mix = np.asarray([[0.8, 0.6], [0.3, -0.9]]) @ np.stack([s1, s2])
    a = r.standard_normal((48, 128))
    a /= np.linalg.norm(a, axis=0)
    xs = np.zeros(128)
    xs[[5, 40, 77, 120]] = [1.0, -2.0, 1.5, 0.7]
    qam = np.array([x + 1j * y for x in (-3, -1, 1, 3) for y in (-3, -1, 1, 3)]) / np.sqrt(10)
    syms = (qam[r.integers(0, 16, 4096)] + 0.05 * (r.standard_normal(4096)
                                                    + 1j * r.standard_normal(4096))).astype(
        np.complex64)
    return [
        ("spectral_subtraction", ap.spectral_subtraction, ref.spectral_subtraction, (noisy,), TOL),
        ("spectral_subtraction_args", lambda x: ap.spectral_subtraction(x[:5000], 4, 128, 2.0, 0.1),
         lambda x: ref.spectral_subtraction(x[:5000], 4, 128, 2.0, 0.1), (noisy,), TOL),
        ("wavelet_denoise", ap.wavelet_denoise, ref.wavelet_denoise, (noisy[:3000],), TOL),
        ("real_cepstrum", ap.real_cepstrum, ref.real_cepstrum, (voiced,), TOL),
        ("real_cepstrum_nfft", lambda x: ap.real_cepstrum(x, 8192),
         lambda x: ref.real_cepstrum(x, 8192), (voiced,), TOL),
        ("cepstral_pitch", lambda x: ap.cepstral_pitch(x, fs), lambda x: ref.cepstral_pitch(x, fs),
         (voiced,), TOL),
        ("lpc_coefficients", lambda x: ap.lpc_coefficients(x, 8),
         jax.jit(lambda x: ref.lpc_coefficients(x, 8)), (_ar(r),), LOOP_TOL),
        ("lpc_analysis_synthesis", lambda x: ap.lpc_analysis_synthesis(x, 6),
         jax.jit(lambda x: ref.lpc_analysis_synthesis(x, 6)), (voiced[:2400],), LOOP_TOL),
        ("envelope_spectrum", lambda x: ap.envelope_spectrum(x, 1e4),
         lambda x: ref.envelope_spectrum(x, 1e4), (vib,), TOL),
        ("bearing_fault_metric", lambda x: ap.bearing_fault_metric(x, 1e4, 87.0),
         lambda x: ref.bearing_fault_metric(x, 1e4, 87.0), (vib,), TOL),
        ("trilaterate", ap.trilaterate, ref.trilaterate, (anchors, ranges), SOLVE_TOL),
        ("fastica_2x2", ap.fastica_2x2, ref.fastica_2x2, (mix,), LOOP_TOL),
        ("omp", lambda m, y: ap.omp(m, y, 4), lambda m, y: ref.omp(m, y, 4), (a, a @ xs),
         SOLVE_TOL),
        ("modulation_features", _features(ap.modulation_features),
         _features(ref.modulation_features), (syms,), TOL),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,port,want,args,tol", CASES, ids=[c[0] for c in CASES])
def test_parity(name, port, want, args, tol):
    check_parity(port, want, args, tol=tol, label=name)


@pytest.mark.parametrize("n_nan", [0, 1, 2, 5])
def test_nanmedian_even_count_averages(n_nan):
    """jnp.nanmedian's rule over the values that are not NaN: at an even
    count the two middle values averaged (torch.nanmedian takes the lower)."""
    rng = np.random.default_rng(n_nan)
    v = rng.standard_normal((3, 12)).astype(np.float32)
    v[:, rng.permutation(12)[:n_nan]] = np.nan
    v[2] = np.nan                              # an all-NaN row
    got = ap.nanmedian(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.nanmedian(jnp.asarray(v), axis=-1)))


def test_omp_support_is_reference():
    """Each atom is the first maximum; on near-ties the support still
    equals the reference's, and the coefficients agree."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 100))
    a /= np.linalg.norm(a, axis=0)
    a[:, 61] = a[:, 60]                         # a duplicated atom: tied correlations
    x = np.zeros(100)
    x[[3, 60, 90]] = [1.5, 2.0, -1.0]
    y = a @ x
    coef, sup = ap.omp(torch.from_numpy(a.astype(np.float32)), torch.from_numpy(
        y.astype(np.float32)), 3)
    rcoef, rsup = ref.omp(jnp.asarray(a, jnp.float32), jnp.asarray(y, jnp.float32), 3)
    np.testing.assert_array_equal(sup.numpy(), np.asarray(rsup))
    assert 60 in sup.tolist() and 61 not in sup.tolist()
    np.testing.assert_allclose(coef.numpy(), np.asarray(rcoef), atol=SOLVE_TOL)


def test_fastica_separates_like_reference():
    """Each separated source correlates with one true source as strongly
    as the reference's does, and with the same one."""
    rng = np.random.default_rng(5)
    s = np.stack([np.sign(rng.standard_normal(20000)), rng.uniform(-1.7, 1.7, 20000)])
    mix = np.asarray([[0.8, 0.6], [0.3, -0.9]]) @ s
    got, _ = ap.fastica_2x2(torch.from_numpy(mix.astype(np.float32)))
    want, _ = ref.fastica_2x2(jnp.asarray(mix, jnp.float32))
    c_got = np.abs(np.corrcoef(np.vstack([got.numpy(), s]))[:2, 2:])
    c_want = np.abs(np.corrcoef(np.vstack([np.asarray(want), s]))[:2, 2:])
    np.testing.assert_array_equal(c_got.argmax(axis=1), c_want.argmax(axis=1))
    np.testing.assert_allclose(c_got.max(axis=1), c_want.max(axis=1), atol=LOOP_TOL)
    assert c_got.max(axis=1).min() > 0.95


@pytest.mark.parametrize("frame", ["identification", "altitude"])
def test_adsb_frames_equal_reference(frame):
    if frame == "identification":
        got = adsb.encode_identification(0x4840D6, "KLM1023")
        want = ref_adsb.encode_identification(0x4840D6, "KLM1023")
    else:
        got = adsb.encode_altitude(0xABCDEF, 38000)
        want = ref_adsb.encode_altitude(0xABCDEF, 38000)
    np.testing.assert_array_equal(got, want)
    assert adsb.crc24(got) == ref_adsb.crc24(want)
    data = np.packbits(got.astype(np.uint8)).tobytes()
    assert asdict(adsb.decode_frame_bytes(data)) == asdict(ref_adsb.decode_frame_bytes(data))


def test_adsb_ppm_iq_equals_reference():
    msg = adsb.AdsbMessage(icao=0x3C6DD0, type_code=4, callsign="DLH9U")
    iq = adsb.transmit_over_ppm(msg, 8e6, device="cpu")
    want = np.asarray(ref_adsb.transmit_over_ppm(ref_adsb.AdsbMessage(
        icao=0x3C6DD0, type_code=4, callsign="DLH9U"), 8e6))
    np.testing.assert_array_equal(iq.numpy(), want)
    assert asdict(adsb.receive_over_ppm(iq, 8e6)) == asdict(ref_adsb.receive_over_ppm(
        jnp.asarray(want), 8e6))
