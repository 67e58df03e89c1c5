"""`ops.adaptive` and `ops.kalman` against the JAX package.

Each function gets the inputs of its JAX test (tests/test_adaptive_kalman.py)
on both sides, made from the same seeds in numpy. The block algorithms agree
within TOL of the largest reference magnitude; the step loops (LMS, RLS, the
lattice, the Kalman filters) within LOOP_TOL, float32 sums and products that
XLA fuses or orders otherwise over thousands of steps; the least-squares
fit within LSTSQ_TOL (``torch.linalg.lstsq``'s QR against JAX's SVD). The
IIR comb runs on the recursion kernel (its lanes as rows) and equals JAX
bit for bit. The reference's own test functions also run on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import adaptive as ref_adaptive
from r4w_tpu.ops import kalman as ref_kalman
from r4w_tpu_torch.ops import adaptive, kalman
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5
LOOP_TOL = 1e-4
LSTSQ_TOL = 1e-4   # of the largest coefficient


def _cplx(rng, n) -> np.ndarray:
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


R = np.random.default_rng(21)
PA_C = np.zeros((3, 3), np.complex64)
PA_C[0, 0], PA_C[1, 0], PA_C[0, 1] = 1.0, -0.1 + 0.05j, 0.08j
PA_X = (_cplx(R, 3000) * 0.3).astype(np.complex64)

CASES = [
    ("wiener_filter", ((np.exp(2j * np.pi * 0.05 * np.arange(4096)) + 0.5 * _cplx(R, 4096))
                       .astype(np.complex64), 0.5), {"nfft": 256}, TOL),
    ("wiener_filter", (_cplx(R, 1000), 0.3), {"nfft": 128}, TOL),
    ("savgol_smooth", ((1.0 + 2.0 * np.linspace(-1, 1, 101) + 3.0 * np.linspace(-1, 1, 101) ** 2)
                       .astype(np.float32),), {"window": 11, "polyorder": 3}, TOL),
    ("savgol_smooth", (R.standard_normal(400).astype(np.float32),),
     {"window": 21, "polyorder": 3}, TOL),
    ("lattice_filter", (np.zeros(4), R.standard_normal(64).astype(np.float32)), {}, LOOP_TOL),
    ("lattice_filter", (ref_adaptive.lattice_from_lpc([1.0, -0.5, 0.25]),
                        R.standard_normal(128).astype(np.float32)), {}, LOOP_TOL),
    ("comb_feedforward", (np.cos(2 * np.pi * np.arange(1024) / 8).astype(np.float32), 8),
     {"alpha": -1.0}, TOL),
    ("comb_feedback", (np.eye(1, 64, 0, np.float32)[0], 4), {"alpha": 0.5}, 0.0),
    ("comb_feedback", (R.standard_normal(20_000).astype(np.float32), 7), {"alpha": 0.9}, 0.0),
    ("comb_feedback", (R.standard_normal((2, 999)).astype(np.float32), 5), {"alpha": 0.7}, 0.0),
    ("lms_filter", (R.standard_normal(4000).astype(np.float32),
                    R.standard_normal(4000).astype(np.float32), 4), {"mu": 0.5}, LOOP_TOL),
    ("memory_polynomial_apply", (PA_C, PA_X), {}, TOL),
    ("nmse_db", (PA_X, PA_X * np.float32(1.01)), {}, TOL),
    ("fft_filter", (R.standard_normal(63).astype(np.float32), _cplx(R, 1000)), {}, TOL),
    ("fft_filter", (R.standard_normal(15).astype(np.float32),
                    R.standard_normal((2, 700)).astype(np.float32)), {"nfft": 64}, TOL),
]


@pytest.mark.parametrize("name,args,kwargs,tol", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_adaptive_against_jax(name, args, kwargs, tol):
    check_parity(getattr(adaptive, name), getattr(ref_adaptive, name), args, kwargs, tol, name)


def test_lms_identifies_the_reference_channel():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4000).astype(np.float32)
    d = np.convolve(x, [0.8, -0.4, 0.2, 0.1])[:4000].astype(np.float32)
    check_parity(lambda a, b: adaptive.lms_filter(a, b, 4, 0.5),
                 lambda a, b: ref_adaptive.lms_filter(a, b, 4, 0.5), (x, d), {}, LOOP_TOL)


def test_rls_and_notch_against_jax():
    rng = np.random.default_rng(4)
    x = _cplx(rng, 1500)
    d = np.convolve(x, [0.7 + 0.3j, -0.2 + 0.5j, 0.1 - 0.1j])[:1500].astype(np.complex64)
    check_parity(lambda a, b: adaptive.rls_filter(a, b, 3, lam=0.995),
                 lambda a, b: ref_adaptive.rls_filter(a, b, 3, lam=0.995), (x, d), {}, LOOP_TOL)
    tone = (2.0 * np.exp(2j * np.pi * 0.123 * np.arange(1500)) + 0.3 * _cplx(rng, 1500)).astype(
        np.complex64)
    check_parity(lambda a: adaptive.adaptive_notch(a, 32, 0.05),
                 lambda a: ref_adaptive.adaptive_notch(a, 32, 0.05), (tone,), {}, LOOP_TOL)


def test_memory_polynomial_fit_and_am_am_against_jax():
    y = np.asarray(ref_adaptive.memory_polynomial_apply(PA_C, PA_X))
    got = adaptive.identify_memory_polynomial(torch.from_numpy(PA_X), torch.from_numpy(y), 3)
    want = np.asarray(ref_adaptive.identify_memory_polynomial(PA_X, y, memory=3))
    assert np.max(np.abs(got.numpy() - want)) <= LSTSQ_TOL * np.max(np.abs(want))
    drive = np.linspace(0.01, 1.0, 500).astype(np.complex64)
    c = np.zeros((3, 1), np.complex64)
    c[0, 0], c[1, 0] = 1.0, -0.3
    out = np.asarray(ref_adaptive.memory_polynomial_apply(c, drive))
    check_parity(lambda a, b: adaptive.am_am_curve(a, b, 16),
                 lambda a, b: ref_adaptive.am_am_curve(a, b, 16), (drive, out), {}, TOL)


def test_designs_equal_the_reference():
    for args in ((11, 3), (21, 3), (7, 2, 1)):
        np.testing.assert_array_equal(adaptive.savitzky_golay_taps(*args),
                                      ref_adaptive.savitzky_golay_taps(*args))
    for a in ([1.0, -0.5, 0.25], [2.0, 0.3, -0.1, 0.05]):
        np.testing.assert_array_equal(adaptive.lattice_from_lpc(a), ref_adaptive.lattice_from_lpc(a))
    with pytest.raises(ValueError):
        adaptive.savitzky_golay_taps(10, 3)


@pytest.mark.parametrize("params", ["scalar", "constant_velocity"])
def test_kalman_filter_against_jax(params):
    rng = np.random.default_rng(1)
    if params == "scalar":
        z = (1.0 + 0.5 * rng.standard_normal(200)).astype(np.float32)
        got_p, ref_p = kalman.KalmanParams.scalar(1e-5, 0.25, "cpu"), ref_kalman.KalmanParams.scalar(
            1e-5, 0.25)
    else:
        z = (2.0 * np.arange(300) * 0.1 + 0.5 * rng.standard_normal(300)).astype(np.float32)
        got_p = kalman.KalmanParams.constant_velocity(0.1, 1e-2, 0.25, "cpu")
        ref_p = ref_kalman.KalmanParams.constant_velocity(0.1, 1e-2, 0.25)
    check_parity(lambda m: kalman.kalman_filter(got_p, m), lambda m: ref_kalman.kalman_filter(
        ref_p, m), (z,), {}, LOOP_TOL)


def test_ukf_and_nees_against_jax():
    z = (9.0 + 0.5 * np.random.default_rng(2).standard_normal(150)).astype(np.float32)
    got = kalman.ukf_filter(lambda x: x, lambda x: x * x, 1e-6 * np.eye(1), 0.25 * np.eye(1), z,
                            np.asarray([2.0]), np.eye(1), device="cpu")
    want = ref_kalman.ukf_filter(lambda x: x, lambda x: x * x, 1e-6 * np.eye(1), 0.25 * np.eye(1),
                                 jnp.asarray(z), np.asarray([2.0]), np.eye(1))
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= LOOP_TOL * np.max(np.abs(np.asarray(w)))
    truth = np.full((50, 1), 3.0, np.float32)
    check_parity(kalman.nees, ref_kalman.nees, (np.asarray(want[0])[-50:],
                                                np.asarray(want[1])[-50:], truth), {}, TOL)


REFERENCE_TESTS = [
    "test_kalman_scalar_converges", "test_kalman_tracks_ramp", "test_ukf_nonlinear_measurement",
    "test_lms_identifies_channel", "test_rls_identifies_complex_channel",
    "test_adaptive_notch_removes_tone", "test_savgol_preserves_polynomial",
    "test_savgol_smooths_noise", "test_wiener_denoises", "test_lattice_zero_reflection_is_passthrough",
    "test_lattice_matches_direct_fir", "test_comb_feedforward_nulls",
    "test_comb_feedback_impulse_response", "test_memory_polynomial_identification",
    "test_am_am_curve_monotone_for_compressive_pa", "test_fft_filter_matches_direct",
]


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_reference_adaptive_kalman_tests_on_the_port(monkeypatch, name):
    run_reference_test(monkeypatch, "test_adaptive_kalman", name,
                       adaptive="r4w_tpu_torch.ops.adaptive", kalman="r4w_tpu_torch.ops.kalman",
                       filters="r4w_tpu_torch.ops.filters")
