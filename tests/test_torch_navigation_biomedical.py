"""`ops.navigation` and `ops.biomedical` against the JAX package.

TestNavigation, TestEcg and TestEegEmg of tests/test_bio_nav_instruments.py
and the navigation and biomedical cases of the known-answer files (r4c,
r4l) run on the port through `torch_port_proxy`. Parity cases hold every
array function against the reference on the same numpy inputs, each with
its tolerance: the elementwise functions within TOL; the Mahony, strapdown
and Luenberger step loops within LOOP_TOL of the track's peak (the
reference's compiled step contracts more of its quaternion products into
fused multiply-adds than the port's integrations, so a few float32 ulps
part the two over 3,000 steps; measured ≤ 5e-7 of the peak); the QRS peaks,
the motor units and the species features equal.

The trap tests: the particle filter's key chain draws JAX's own numbers
(normals within THREEFRY_TOL, uniforms bit for bit); its first step's
estimate agrees within TOL, and the free-running track agrees to the
filter's Monte-Carlo noise: an ulp at a resampling edge (the reference's
float32 cumulative sum against the port's float64 one, rounded once) moves
a resampled index, after which the two ensembles are different samples of
one posterior (PF_MEAN_TOL of r_std on average; the RMSE against the truth
within PF_RMSE_REL of the reference's); the QRS integrator's even-length
box (54 samples at 360 Hz) takes numpy's centre; the rows of a batched
QRS, ECG or EMG call equal their one-row calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from r4w_tpu.ops import biomedical as ref_bio
from r4w_tpu.ops import navigation as ref_nav
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.ops import biomedical as bio
from r4w_tpu_torch.ops import navigation as nav
from r4w_tpu_torch.ops.audio import _convolve_same
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5
LOOP_TOL = 1e-5
THREEFRY_TOL = 3e-7
PF_MEAN_TOL = 0.1
PF_RMSE_REL = 0.1

NAV = "r4w_tpu_torch.ops.navigation"
BIO = "r4w_tpu_torch.ops.biomedical"
KA = {"r4w_tpu.ops.navigation": NAV, "r4w_tpu.ops.biomedical": BIO}

REFERENCE_TESTS = [
    *[("test_bio_nav_instruments", f"TestNavigation.{n}", {}, {"nav": NAV}, {}) for n in (
        "test_mahony_levels_from_tilt", "test_strapdown_constant_accel",
        "test_imu_aiding_pulls_to_fix", "test_magnetometer_heading",
        "test_particle_filter_tracks_ramp", "test_luenberger_estimates_velocity",
        "test_fusion_weights_by_variance")],
    *[("test_bio_nav_instruments", n, {}, {"bio": BIO}, {}) for n in (
        "TestEcg.test_qrs_detection_rate", "TestEcg.test_arrhythmia_rules",
        "TestEcg.test_ecg_clean_removes_mains", "TestEegEmg.test_band_powers_alpha",
        "TestEegEmg.test_emg_decomposition_two_units",
        "TestEegEmg.test_gesture_features_and_classify", "TestEegEmg.test_species_features")],
    *[("test_known_answers_r4c", "test_quat_rotate_matches_scipy_rotation", {}, {"NAV": NAV},
       {"seed": s}) for s in (0, 1, 2)],
    *[("test_known_answers_r4c", n, {}, {"NAV": NAV}, {}) for n in (
        "test_quat_multiply_composes_like_scipy", "test_quat_to_euler_matches_scipy_zyx",
        "test_mahony_integrates_constant_yaw_rate", "test_mahony_levels_from_tilted_start",
        "test_strapdown_constant_accel_quadratic_position", "test_imu_aided_update_exact_blend",
        "test_magnetometer_rotate_headings", "test_particle_filter_beats_raw_measurement_noise",
        "test_luenberger_observer_matches_numpy_recursion_and_converges",
        "test_spatio_temporal_fuse_inverse_variance_exact")],
    ("test_known_answers_r4l", "TestEegBandPowers.test_alpha_tone_dominates_and_band_edges_bind",
     KA, {}, {}),
    ("test_known_answers_r4l", "TestQrsDetect.test_synthetic_rhythm_count_and_timing", KA, {},
     {}),
]


@pytest.mark.parametrize("module,name,modules,swaps,params", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}{t[4] or ''}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps, params):
    run_reference_test(monkeypatch, module, name, modules, params=params, **swaps)


def _ecg(fs=250.0, bpm=72.0, n_s=20.0, seed=0):
    rng = np.random.default_rng(seed)
    n = int(fs * n_s)
    x = 0.02 * rng.standard_normal(n)
    t = 0.3
    while t * fs < n - 50:
        k = int(t * fs)
        x[k - 5:k + 6] += np.exp(-0.5 * ((np.arange(-5, 6)) / 1.5) ** 2)
        t += 60.0 / bpm
    return x.astype(np.float32)


def _rhythm(fs=360.0, dur=10.0, rr=0.8, seed=17):
    n = int(dur * fs)
    t = np.arange(n) / fs
    ecg = np.zeros(n, np.float32)
    for tc in np.arange(0.5, dur - 0.3, rr):
        ecg += np.exp(-0.5 * ((t - tc) / 0.012) ** 2).astype(np.float32)
    return ecg + 0.02 * np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _listed(fn):
    """A dict of scalars as one array of its values in key order, so each is
    held relative to the largest (a band's leakage power is a roundoff of
    the tone's)."""
    def call(*a, **k):
        out = fn(*a, **k)
        vals = [out[key] for key in sorted(out)]
        return (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                else jnp.stack([jnp.asarray(v, jnp.float32) for v in vals]))
    return call


_R = np.random.default_rng(40)
_G_BODY = Rotation.from_euler("x", -0.3).apply([0.0, 0.0, 9.81])
_GYRO = (0.3 * _R.standard_normal((3000, 3))).astype(np.float32)
_ACCEL = (np.tile(_G_BODY, (3000, 1)) + _R.standard_normal((3000, 3))).astype(np.float32)
_SD_ACCEL = (np.tile([2.0, 0.0, 9.81], (500, 1)) + _R.standard_normal((500, 3))).astype(
    np.float32)
_SD_GYRO = (0.2 * _R.standard_normal((500, 3))).astype(np.float32)
_Q = _R.standard_normal(4)
_Q = (_Q / np.linalg.norm(_Q)).astype(np.float32)
_QS = _R.standard_normal((6, 4))
_QS = (_QS / np.linalg.norm(_QS, axis=1, keepdims=True)).astype(np.float32)
_VS = _R.standard_normal((6, 3)).astype(np.float32)
_A = np.asarray([[0.95, 0.1], [0.0, 0.9]], np.float32)
_B = np.asarray([[0.0], [1.0]], np.float32)
_C = np.asarray([1.0, 0.0], np.float32)
_L = np.asarray([0.4, 0.3], np.float32)
_Y = _R.standard_normal(120).astype(np.float32)
_U = (0.1 * np.ones((120, 1))).astype(np.float32)
_FS = 250.0
_T = np.arange(2500) / _FS
_MAINS = (np.sin(2 * np.pi * 1.2 * _T) + 0.5 * np.sin(2 * np.pi * 50 * _T)).astype(np.float32)
_ALPHA = np.sin(2 * np.pi * 10 * np.arange(5000) / _FS).astype(np.float32)
_MU = np.zeros(20000, np.float32)
_MU[500:20000:1500] = 2.0
_MU[1100:20000:1700] = 0.8
_EMG = _R.standard_normal(8000).astype(np.float32)
_CH = _R.standard_normal((2, 1000)).astype(np.float32)
_SFS = 22050.0
_ST = np.arange(int(_SFS)) / _SFS
_CALL = ((np.sin(2 * np.pi * 4 * _ST) > 0.5) * np.sin(2 * np.pi * 3000 * _ST)).astype(np.float32)

PARITY = [
    ("quat_multiply", nav.quat_multiply, ref_nav.quat_multiply, (_QS, _QS[::-1].copy()), TOL),
    ("quat_rotate", nav.quat_rotate, ref_nav.quat_rotate, (_QS, _VS), TOL),
    ("quat_to_euler", nav.quat_to_euler, ref_nav.quat_to_euler, (_QS,), TOL),
    ("attitude_track_mahony", lambda g, a: nav.attitude_track_mahony(g, a, 0.01, kp=2.0),
     lambda g, a: ref_nav.attitude_track_mahony(g, a, 0.01, kp=2.0), (_GYRO, _ACCEL), LOOP_TOL),
    ("strapdown_integrate", lambda a, g: nav.strapdown_integrate(a, g, 0.01),
     lambda a, g: ref_nav.strapdown_integrate(a, g, 0.01), (_SD_ACCEL, _SD_GYRO), LOOP_TOL),
    ("imu_aided_update", lambda p, v, f: nav.imu_aided_update(p, v, f, 0.3),
     lambda p, v, f: ref_nav.imu_aided_update(p, v, f, 0.3), (_VS, _VS[::-1].copy(), -_VS), TOL),
    ("magnetometer_rotate", nav.magnetometer_rotate, ref_nav.magnetometer_rotate, (_VS, _QS),
     TOL),
    ("luenberger_observe", lambda y, u: nav.luenberger_observe(y, _A, _B, _C, _L, u),
     lambda y, u: ref_nav.luenberger_observe(y, _A, _B, _C, _L, u), (_Y, _U), LOOP_TOL),
    ("spatio_temporal_fuse", nav.spatio_temporal_fuse, ref_nav.spatio_temporal_fuse,
     (_R.standard_normal((3, 40, 2)).astype(np.float32), np.float32([0.1, 1.0, 4.0])), TOL),
    ("qrs_detect", lambda x: bio.qrs_detect(x, _FS), lambda x: ref_bio.qrs_detect(x, _FS),
     (_ecg(),), 0),
    ("qrs_detect_360", lambda x: bio.qrs_detect(x, 360.0),
     lambda x: ref_bio.qrs_detect(x, 360.0), (_rhythm(),), 0),
    ("ecg_clean", lambda x: bio.ecg_clean(x, _FS), lambda x: ref_bio.ecg_clean(x, _FS),
     (_MAINS,), TOL),
    ("eeg_band_powers", _listed(lambda x: bio.eeg_band_powers(x, _FS)),
     _listed(lambda x: ref_bio.eeg_band_powers(x, _FS)), (_ALPHA,), TOL),
    ("bci_alpha_blocking", lambda a, b: bio.bci_alpha_blocking(a, b, _FS),
     lambda a, b: ref_bio.bci_alpha_blocking(a, b, _FS), (_ALPHA, 0.1 * _ALPHA), TOL),
    ("emg_envelope", lambda x: bio.emg_envelope(x, 2000.0),
     lambda x: ref_bio.emg_envelope(x, 2000.0), (_EMG,), TOL),
    ("emg_decompose_mu", lambda x: bio.emg_decompose_mu(x, 2000.0, threshold_sigma=3.0),
     lambda x: ref_bio.emg_decompose_mu(x, 2000.0, threshold_sigma=3.0), (_MU,), 0),
    ("emg_decompose_mu_noise", lambda x: bio.emg_decompose_mu(x, 2000.0, n_units=3),
     lambda x: ref_bio.emg_decompose_mu(x, 2000.0, n_units=3), (_EMG,), 0),
    ("emg_gesture_features", lambda x: bio.emg_gesture_features(x, 2000.0),
     lambda x: ref_bio.emg_gesture_features(x, 2000.0), (_CH,), TOL),
    ("species_features", _listed(lambda x: bio.species_features(x, _SFS)),
     _listed(lambda x: ref_bio.species_features(x, _SFS)), (_CALL,), TOL),
]


@pytest.mark.parametrize("name,port,ref,args,tol", PARITY, ids=[p[0] for p in PARITY])
def test_parity(name, port, ref, args, tol):
    check_parity(port, ref, args, tol=tol, label=name)


@pytest.mark.parametrize("peaks", [[0, 250, 500, 760, 1000], np.arange(0, 4000, 180)])
def test_heart_rate_and_rhythm_equal_reference(peaks):
    np.testing.assert_array_equal(bio.heart_rate_series(torch.tensor(np.asarray(peaks)),
                                                        250.0).numpy(),
                                  np.asarray(ref_bio.heart_rate_series(peaks, 250.0)))
    assert bio.arrhythmia_classify(torch.tensor(np.asarray(peaks)), 250.0) == \
        ref_bio.arrhythmia_classify(peaks, 250.0)


def test_particle_filter_draws_are_jax_draws():
    key = jax.random.key(0)
    pos0, vel0, noise, uniform = nav.particle_draws((0, 0), 512, 4)
    k1, k2 = jax.random.split(key)
    np.testing.assert_allclose(pos0, np.asarray(jax.random.normal(k1, (512,))), rtol=0,
                               atol=THREEFRY_TOL * 4)
    np.testing.assert_allclose(vel0, np.asarray(jax.random.normal(k2, (512,))), rtol=0,
                               atol=THREEFRY_TOL * 4)
    carry = jax.random.split(key)[0]
    for t in range(4):
        carry, kq, kr = jax.random.split(carry, 3)
        np.testing.assert_allclose(noise[t], np.asarray(jax.random.normal(kq, (512,))), rtol=0,
                                   atol=THREEFRY_TOL * 4)
        assert uniform[t] == np.asarray(jax.random.uniform(kr))
    assert threefry.key(0) == (0, 0)


@pytest.mark.parametrize("seed,n,kw", [(12, 512, {}), (17, 1024, {"q_std": 0.05, "r_std": 2.0})])
def test_particle_filter_track_within_monte_carlo_noise(seed, n, kw):
    rng = np.random.default_rng(seed)
    truth = 0.5 * np.arange(200)
    r_std = kw.get("r_std", 1.0)
    z = (truth + 2.0 * rng.standard_normal(200)).astype(np.float32)
    got = nav.particle_filter_track(torch.from_numpy(z), (0, 0), n_particles=n, **kw).numpy()
    want = np.asarray(ref_nav.particle_filter_track(z, jax.random.key(0), n_particles=n, **kw))
    assert abs(got[0] - want[0]) <= TOL * abs(want[0]) + 1e-6
    assert np.mean(np.abs(got - want)) <= PF_MEAN_TOL * r_std
    rmse = lambda v: np.sqrt(np.mean((v[50:] - truth[50:]) ** 2))
    assert abs(rmse(got) - rmse(want)) <= PF_RMSE_REL * rmse(want)
    # rows draw the key's numbers: a batched call equals its one-row calls
    rows = nav.particle_filter_track(torch.from_numpy(np.stack([z, z[::-1].copy()])), (0, 0),
                                     n_particles=n, **kw).numpy()
    np.testing.assert_array_equal(rows[0], got)


def test_qrs_even_box_takes_numpy_centre():
    fs = 360.0
    w = int(0.15 * fs)
    assert w % 2 == 0
    box = np.ones(w, np.float32) / np.float32(w)
    sq = (np.random.default_rng(3).standard_normal(3600) ** 2).astype(np.float32)
    got = _convolve_same(torch.from_numpy(sq), box).numpy()
    np.testing.assert_allclose(got, np.convolve(sq, box, mode="same"), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jnp.convolve(sq, box, mode="same")), rtol=0,
                               atol=1e-6)
    # a box one sample off centre moves every detected peak
    peaks, valid = bio.qrs_detect(torch.from_numpy(_rhythm()), fs)
    ref_peaks, ref_valid = ref_bio.qrs_detect(_rhythm(), fs)
    np.testing.assert_array_equal(peaks.numpy(), np.asarray(ref_peaks))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))


def test_rows_equal_one_row_calls():
    rows = np.stack([_ecg(), _ecg(bpm=60.0, seed=4)])
    peaks, valid = bio.qrs_detect(torch.from_numpy(rows), 250.0)
    clean = bio.ecg_clean(torch.from_numpy(rows), 250.0)
    env = bio.emg_envelope(torch.from_numpy(rows), 250.0)
    for i, r in enumerate(rows):
        p1, v1 = bio.qrs_detect(torch.from_numpy(r), 250.0)
        np.testing.assert_array_equal(peaks[i].numpy(), p1.numpy())
        np.testing.assert_array_equal(valid[i].numpy(), v1.numpy())
        np.testing.assert_allclose(clean[i].numpy(), bio.ecg_clean(torch.from_numpy(r),
                                                                   250.0).numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(env[i].numpy(),
                                      bio.emg_envelope(torch.from_numpy(r), 250.0).numpy())
    gyro, accel = np.stack([_GYRO[:300], _GYRO[300:600]]), np.stack([_ACCEL[:300],
                                                                     _ACCEL[300:600]])
    track = nav.attitude_track_mahony(torch.from_numpy(gyro), torch.from_numpy(accel), 0.01)
    one = nav.attitude_track_mahony(torch.from_numpy(gyro[1]), torch.from_numpy(accel[1]), 0.01)
    np.testing.assert_array_equal(track[1].numpy(), one.numpy())
