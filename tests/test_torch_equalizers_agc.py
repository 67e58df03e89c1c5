"""The port's equalizers and AGC/transform blocks against
``r4w_tpu.ops.equalizers`` and ``r4w_tpu.ops.agc`` on the same numpy
inputs, made from seeds; then the JAX package's own tests of those
modules (``tests/test_infra.py``, ``tests/test_named_blocks.py`` and
``tests/test_adsb_ephemeris.py``) run on the port.

MLSE decisions, the DFE (its step rounds as the reference's compiled
step does), slicer decisions, the trellis tables, CORDIC and the
host-side chirps are exact. Each other comparison is max|port −
reference| / max|reference| within the tolerance named beside it, with
the measured value in its comment: the adaptive equalizers and the AGC
are float32 recursions over thousands of steps whose sums and products
XLA's compiled scan orders and fuses its own way. RLS propagates its
inverse-correlation matrix P through a division by λ every step, which
amplifies each step's rounding; its drift is measured on the reference
test's 800 symbols and held to `RLS_TOL`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import agc as ref_agc
from r4w_tpu.ops import equalizers as ref_eq
from r4w_tpu_torch.core.hostio import complex_abs
from r4w_tpu_torch.ops import agc, equalizers
from torch_port_proxy import run_reference_test

SUM_TOL = 5e-6     # block products and FFTs in another order (measured 3.5e-7)
ADAPT_TOL = 1e-5   # LMS, CMA and the time-domain equalizer (measured 6.2e-7)
RLS_TOL = 5e-5     # RLS's P recursion (measured 5.6e-7 over the reference test's 800
                   # symbols, 4.0e-6 as the time-domain equalizer's 300-symbol training)
AGC_TOL = 1e-5     # the AGC's gain recursion (measured 4.5e-7)
TURBO_TOL = 1e-5   # turbo equalization's LLRs after 4 BCJR passes (measured 3.2e-7)
QPSK = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))).astype(np.complex64)


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return 0.0
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _iq(rng, *shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _isi(n: int, seed: int, h, noise: float = 0.02):
    rng = np.random.default_rng(seed)
    syms = QPSK[rng.integers(0, 4, n)]
    rx = np.convolve(syms, np.asarray(h, np.complex64))[:n] + noise * _iq(rng, n)
    return syms, rx.astype(np.complex64)


def test_complex_abs_is_the_references():
    rng = np.random.default_rng(0)
    z = np.concatenate([_iq(rng, 100_000), np.asarray([0, 1e-30, 3e38 + 1j, -2j], np.complex64)])
    np.testing.assert_array_equal(complex_abs(_t(z)).numpy(), np.asarray(jnp.abs(jnp.asarray(z))))


def test_lms_cma_and_dfe():
    syms, rx = _isi(1500, 1, [1.0, 0.4, -0.2])
    got = equalizers.lms_equalize(_t(rx), _t(syms), 9, 0.02)
    want = ref_eq.lms_equalize(jnp.asarray(rx), jnp.asarray(syms), 9, 0.02)
    assert type(got).__name__ == "EqOut" and got._fields == want._fields
    for g, w in zip(got, want):
        assert _rel(g, w) < ADAPT_TOL
    taps0 = _iq(np.random.default_rng(2), 9) * 0.1
    for g, w in zip(equalizers.lms_equalize(_t(rx), _t(syms), 9, 0.01, _t(taps0)),
                    ref_eq.lms_equalize(jnp.asarray(rx), jnp.asarray(syms), 9, 0.01,
                                        jnp.asarray(taps0))):
        assert _rel(g, w) < ADAPT_TOL
    for g, w in zip(equalizers.cma_equalize(_t(rx), 11, 0.002),
                    ref_eq.cma_equalize(jnp.asarray(rx), 11, 0.002)):
        assert _rel(g, w) < ADAPT_TOL
    # the DFE rounds as the reference's compiled step: bit for bit
    for const, n_ff, n_fb in ((None, 7, 3), (QPSK, 7, 3), (QPSK, 3, 5)):
        got = equalizers.dfe_equalize(_t(rx), n_ff, n_fb, 0.01, const)
        want = ref_eq.dfe_equalize(jnp.asarray(rx), n_ff, n_fb, 0.01, const)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rls_drift():
    """RLS on the reference test's inputs (tests/test_infra.py:44): the
    symbols' drift from the reference stays within RLS_TOL, and the
    decisions are equal."""
    rng = np.random.default_rng(1)
    syms = ((rng.choice([-1, 1], 800) + 1j * rng.choice([-1, 1], 800)) / np.sqrt(2)
            ).astype(np.complex64)
    rx = np.convolve(syms, np.array([1.0, 0.5], np.complex64))[:800].astype(np.complex64)
    got = equalizers.rls_equalize(_t(rx), _t(syms), 7)
    want = ref_eq.rls_equalize(jnp.asarray(rx), jnp.asarray(syms), 7)
    for g, w in zip(got, want):
        assert _rel(g, w) < RLS_TOL
    np.testing.assert_array_equal(np.sign(got.y.numpy().real), np.sign(np.asarray(want.y).real))


def test_block_equalizers():
    syms, rx = _isi(500, 3, [0.8, 0.5, 0.3])
    for kw in ({}, {"snr_db": 30.0, "n_taps": 11, "delay": 4}):
        y, w = equalizers.mmse_block_equalize(_t(rx), np.asarray([0.8, 0.5, 0.3]), **kw)
        ry, rw = ref_eq.mmse_block_equalize(jnp.asarray(rx), np.asarray([0.8, 0.5, 0.3]), **kw)
        np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
        assert _rel(y, ry) < SUM_TOL
    rng = np.random.default_rng(4)
    h = np.zeros(64, np.complex64)
    h[0], h[3] = 1.0, 0.5
    blocks = _iq(rng, 3, 64)
    assert _rel(equalizers.fde_equalize(_t(blocks), _t(np.fft.fft(h).astype(np.complex64)), 25.0),
                ref_eq.fde_equalize(jnp.asarray(blocks), np.fft.fft(h).astype(np.complex64),
                                    25.0)) < SUM_TOL


def test_nearest_point_and_ties():
    rng = np.random.default_rng(5)
    y = (1.5 * _iq(rng, 3, 200)).astype(np.complex64)
    y[0, :4] = [0, 1 + 0j, 1j, -0.7071068 + 0j]  # on the decision boundaries: the first point
    np.testing.assert_array_equal(equalizers.nearest_point(_t(y), _t(QPSK)).numpy(),
                                  np.asarray(ref_eq.nearest_point(jnp.asarray(y),
                                                                  jnp.asarray(QPSK))))


@pytest.mark.parametrize("algorithm,train,const", [("lms", 400, True), ("rls", 300, True),
                                                   ("nlms", 400, True), ("lms", 400, False),
                                                   ("lms", None, True)])
def test_time_domain_equalizer(algorithm, train, const):
    syms, rx = _isi(1200, 7, [1.0, 0.4 + 0.2j, 0.1])
    kw = {"reference": syms[:train] if train else None,
          "constellation": QPSK if const else None}
    got = equalizers.time_domain_equalizer(_t(rx), 15, algorithm, 0.01, **kw)
    want = ref_eq.time_domain_equalizer(jnp.asarray(rx), 15, algorithm, 0.01, **kw)
    tol = RLS_TOL if algorithm == "rls" else ADAPT_TOL
    for g, w in zip(got, want):
        assert _rel(g, w) < tol
    np.testing.assert_array_equal(
        equalizers.nearest_point(got.y[600:], _t(QPSK)).numpy(),
        np.asarray(ref_eq.nearest_point(want.y[600:], jnp.asarray(QPSK))))


def test_turbo_equalizer():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 512)
    x, coded, pi = equalizers.turbo_equalizer_tx(bits, device="cpu")
    rx_, rcoded, rpi = ref_eq.turbo_equalizer_tx(bits)
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx_))
    np.testing.assert_array_equal(coded, rcoded)
    np.testing.assert_array_equal(pi, rpi)
    h = np.array([0.407, 0.815, 0.407], np.complex64)
    m = len(coded)
    n0 = 1 / 10 ** (4.0 / 10)
    y = (np.fft.ifft(np.fft.fft(x.numpy()) * np.fft.fft(h, m))
         + rng.normal(0, np.sqrt(n0 / 2), m) + 1j * rng.normal(0, np.sqrt(n0 / 2), m)
         ).astype(np.complex64)
    for iters in (1, 4):
        hard, post = equalizers.turbo_equalize(_t(y), h, pi, n0, iters)
        rhard, rpost = ref_eq.turbo_equalize(jnp.asarray(y), h, pi, n0, iters)
        np.testing.assert_array_equal(hard.numpy(), np.asarray(rhard))
        assert _rel(post, rpost) < TURBO_TOL


@pytest.mark.parametrize("h,n_sym", [([1.0, 0.55j, -0.2], 600), ([0.71, 0.0, 0.7], 600),
                                     ([1.0, 0.9], 200), ([1.0], 50)])
def test_mlse(h, n_sym):
    syms, rx = _isi(n_sym, 9, h, 0.07)
    h = np.asarray(h, np.complex64)
    batch = np.stack([rx, rx[::-1].copy()])
    np.testing.assert_array_equal(
        equalizers.mlse_equalize(_t(batch), h, QPSK).numpy(),
        np.asarray(ref_eq.mlse_equalize(jnp.asarray(batch), h, jnp.asarray(QPSK))))
    emit, prev_state, prev_sym = equalizers._mlse_trellis(h, QPSK)
    assert emit.shape == (4 ** (len(h) - 1), 4) and prev_state.shape == prev_sym.shape


def test_mlse_rejects_a_huge_trellis():
    with pytest.raises(ValueError):
        equalizers.mlse_equalize(torch.zeros(4, dtype=torch.complex64), np.ones(9), QPSK)


# ---------------------------------------------------------------- agc


def test_agc_loop_and_block():
    rng = np.random.default_rng(11)
    x = np.concatenate([0.05 * _iq(rng, 2, 700), 4 * _iq(rng, 2, 600)], axis=-1)
    for kw in ({}, {"target_level": 0.5, "attack": 0.05, "decay": 0.02, "gain0": 3.0,
                    "max_gain": 50.0}):
        # the reference's loop carries one gain: a 1-D stream
        for g, w in zip(agc.agc(_t(x[0]), **kw), ref_agc.agc(jnp.asarray(x[0]), **kw)):
            assert _rel(g, w) < AGC_TOL
        # the port's leading axes are independent loops
        for row in range(2):
            for g, w in zip(agc.agc(_t(x), **kw), agc.agc(_t(x[row]), **kw)):
                torch.testing.assert_close(g[row], w, rtol=0, atol=0)
    for block in (256, 100):
        assert _rel(agc.agc_block(_t(x), 2.0, block),
                    ref_agc.agc_block(jnp.asarray(x), 2.0, block)) < SUM_TOL


def test_cordic():
    rng = np.random.default_rng(12)
    xs, ys = rng.standard_normal((2, 500)).astype(np.float32)
    ang = rng.uniform(-4, 4, 500).astype(np.float32)
    for iters in (16, 24, 8):
        for g, w in zip(agc.cordic_rotate(_t(xs), _t(ys), _t(ang), iters),
                        ref_agc.cordic_rotate(jnp.asarray(xs), jnp.asarray(ys),
                                              jnp.asarray(ang), iters)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(agc.cordic_magnitude_phase(_t(xs), _t(ys), iters),
                        ref_agc.cordic_magnitude_phase(jnp.asarray(xs), jnp.asarray(ys), iters)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_chirp_z_zoom_cyclo_and_wigner():
    rng = np.random.default_rng(13)
    x = _iq(rng, 2, 300)
    for m, w, a in ((64, np.exp(-2j * np.pi / 64), 1.0 + 0j), (500, np.exp(-0.01j), 0.9 + 0.1j),
                    (17, np.exp(-0.3j), np.exp(0.2j))):
        assert _rel(agc.chirp_z_transform(_t(x), m, w, a),
                    ref_agc.chirp_z_transform(jnp.asarray(x), m, w, a)) < SUM_TOL
    assert _rel(agc.zoom_fft(_t(x), 100.0, 150.0, 200, 1000.0),
                ref_agc.zoom_fft(jnp.asarray(x), 100.0, 150.0, 200, 1000.0)) < SUM_TOL
    bits = rng.choice([-1.0, 1.0], 400)
    y = (np.repeat(bits, 10) + 0.3 * _iq(rng, 4000)).astype(np.complex64)
    for alpha, nfft in ((100.0, 256), (173.0, 128)):
        assert _rel(agc.cyclostationary_detector(_t(y), alpha, 1000.0, nfft),
                    ref_agc.cyclostationary_detector(jnp.asarray(y), alpha, 1000.0, nfft)) < 1e-4
    for nfft in (64, 32):
        assert _rel(agc.wigner_ville(_t(x[0]), nfft),
                    ref_agc.wigner_ville(jnp.asarray(x[0]), nfft)) < SUM_TOL


# ------------------------------------------- the reference's own tests


@pytest.mark.parametrize("name", [
    "test_lms_converges_on_isi_channel", "test_rls_converges_faster_than_lms",
    "test_cma_restores_constant_modulus", "test_mmse_block_equalizer_opens_eye",
    "test_fde_equalizer_inverts_channel"])
def test_reference_infra_equalizer_tests_on_the_port(monkeypatch, name):
    """tests/test_infra.py's equalizer tests, their bars applied to the port."""
    run_reference_test(monkeypatch, "test_infra", name, eq="r4w_tpu_torch.ops.equalizers")


@pytest.mark.parametrize("name", [
    "test_turbo_equalize_iteration_gain", "test_time_domain_equalizer_train_then_dd",
    "test_nearest_point_known_answer"])
def test_reference_named_block_equalizer_tests_on_the_port(monkeypatch, name):
    """tests/test_named_blocks.py's equalizer tests on the port."""
    run_reference_test(monkeypatch, "test_named_blocks", name, eq="r4w_tpu_torch.ops.equalizers")


@pytest.mark.parametrize("name", [
    "test_agc_reaches_target", "test_cordic_rotation_and_vectoring",
    "test_chirp_z_equals_fft_on_unit_circle", "test_zoom_fft_resolves_fine_frequency",
    "test_cyclostationary_peaks_at_symbol_rate", "test_wigner_ville_tracks_chirp"])
def test_reference_agc_tests_on_the_port(monkeypatch, name):
    """tests/test_adsb_ephemeris.py's AGC and transform tests on the port."""
    run_reference_test(monkeypatch, "test_adsb_ephemeris", name, dsp="r4w_tpu_torch.ops.agc")
