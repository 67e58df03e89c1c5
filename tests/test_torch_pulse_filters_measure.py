"""The port's pulse shaping, the rest of its filters and of its measurement
ops against ``r4w_tpu.ops.pulse``, ``.filters`` and ``.measure`` on the
same numpy inputs, made from seeds; then the JAX package's own filter,
pulse and measure tests of ``tests/test_ops.py`` run on the port.

Tap designs, windows, gathers, histograms, sorts and host-side formulas
are exact. Each other comparison is max|port − reference| / max|reference|
within the tolerance named beside it (measured values in the comments):
float32 sums in another order (FFTs, FIR taps, windowed sums), or a
float32 recursion that XLA's compiled scan fuses into FMAs where the
port's steps round each product.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import filters as ref_filters
from r4w_tpu.ops import measure as ref_measure
from r4w_tpu.ops import pulse as ref_pulse
from r4w_tpu_torch.ops import filters, measure, pulse
from torch_port_proxy import run_reference_test

REPO = Path(__file__).resolve().parents[1]
FIR_TOL = 2e-6        # an FIR's float32 tap sums in another order (measured 2.6e-7)
FFT_TOL = 2e-6        # float32 transforms: pocketfft against XLA's (measured 9.5e-7)
RECURSION_TOL = 1e-5  # IIR, single-pole and DC-blocker steps (measured 3.6e-7)
WAVELET_TOL = 2e-6    # a DWT level's 2-8 tap sums (measured 3.4e-7)
STAT_TOL = 2e-6       # moving sums and means (measured 3.5e-7)
CIC_TOL = 2e-6        # of the last CIC integrator's largest value (measured 5.3e-7)


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


def _segments(path: Path) -> dict[str, str]:
    text = path.read_text()
    return {node.name: ast.get_source_segment(text, node) for node in ast.parse(text).body
            if isinstance(node, ast.FunctionDef)}


# ---------------------------------------------------------------- pulse


def test_tap_designs_are_the_references_source():
    got = _segments(REPO / "r4w_tpu_torch" / "ops" / "pulse.py")
    want = _segments(REPO / "r4w_tpu" / "ops" / "pulse.py")
    for name in ("raised_cosine_taps", "root_raised_cosine_taps", "gaussian_taps"):
        assert got[name] == want[name], name


@pytest.mark.parametrize("sps,span,beta", [(4, 8, 0.35), (8, 12, 0.35), (2, 6, 0.25),
                                           (128, 8, 0.35), (4, 8, 0.5)])
def test_tap_designs_bit_for_bit(sps, span, beta):
    np.testing.assert_array_equal(pulse.root_raised_cosine_taps(sps, span, beta),
                                  ref_pulse.root_raised_cosine_taps(sps, span, beta))
    np.testing.assert_array_equal(pulse.raised_cosine_taps(sps, span, beta),
                                  ref_pulse.raised_cosine_taps(sps, span, beta))
    np.testing.assert_array_equal(pulse.gaussian_taps(sps, beta, span),
                                  ref_pulse.gaussian_taps(sps, beta, span))


@pytest.mark.parametrize("shape,complex_in", [((40,), True), ((3, 25), True), ((30,), False)])
def test_shape_symbols_and_matched_filter(shape, complex_in):
    rng = np.random.default_rng(1)
    syms = _iq(rng, *shape) if complex_in else rng.standard_normal(shape).astype(np.float32)
    taps = ref_pulse.root_raised_cosine_taps(4, 8, 0.35)
    up = pulse.shape_symbols(_t(syms), taps, 4)
    assert _rel(up, ref_pulse.shape_symbols(jnp.asarray(syms), taps, 4)) < FIR_TOL
    mf = pulse.matched_filter(up, taps)
    assert _rel(mf, ref_pulse.matched_filter(jnp.asarray(up.numpy()), taps)) < FIR_TOL


# ---------------------------------------------------------------- filters


@pytest.mark.parametrize("b,a", [([0.5, 0.5], [1.0, -0.2]),
                                 ([0.2, 0.3, 0.1], [1.0, -0.5, 0.25]),
                                 ([1.0], [2.0, -0.9, 0.1, 0.05])])
@pytest.mark.parametrize("complex_in", [False, True])
def test_iir_filter(b, a, complex_in):
    rng = np.random.default_rng(2)
    x = _iq(rng, 300) if complex_in else rng.standard_normal(300).astype(np.float32)
    y, zf = filters.iir_filter(b, a, _t(x))
    ry, rzf = ref_filters.iir_filter(b, a, jnp.asarray(x))
    assert _rel(y, ry) < RECURSION_TOL and _rel(zf, rzf) < RECURSION_TOL
    # streaming: two blocks with the carried state equal one
    y1, z1 = filters.iir_filter(b, a, _t(x[:170]))
    y2, _ = filters.iir_filter(b, a, _t(x[170:]), z1)
    torch.testing.assert_close(torch.cat([y1, y2]), y, rtol=0, atol=0)


def test_single_pole_and_dc_blocker():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 500)) + 3.0).astype(np.float32)
    y, yf = filters.single_pole_iir(0.1, _t(x))
    ry, ryf = ref_filters.single_pole_iir(0.1, jnp.asarray(x))
    assert _rel(y, ry) < RECURSION_TOL and _rel(yf, ryf) < RECURSION_TOL
    y, (xf, yf) = filters.dc_blocker(_t(x))
    ry, (rxf, ryf) = ref_filters.dc_blocker(jnp.asarray(x))
    assert _rel(y, ry) < RECURSION_TOL and _rel(yf, ryf) < RECURSION_TOL
    np.testing.assert_array_equal(xf.numpy(), np.asarray(rxf))
    xc = _iq(rng, 400)
    y, _ = filters.dc_blocker(_t(xc), 0.99)
    assert _rel(y, ref_filters.dc_blocker(jnp.asarray(xc), 0.99)[0]) < RECURSION_TOL
    y1, s1 = filters.dc_blocker(_t(xc[:150]), 0.99)
    y2, _ = filters.dc_blocker(_t(xc[150:]), 0.99, s1)
    torch.testing.assert_close(torch.cat([y1, y2]), y, rtol=0, atol=0)


@pytest.mark.parametrize("rate,stages", [(4, 3), (8, 2), (5, 4)])
def test_cic_decimator(rate, stages):
    rng = np.random.default_rng(4)
    # integer samples: every cumulative sum is an integer below 2^24, exact in float32
    xi = rng.integers(-8, 9, (2, 120)).astype(np.float32)
    y, (integ, comb) = filters.cic_decimator(_t(xi), rate, stages)
    ry, (rinteg, rcomb) = ref_filters.cic_decimator(jnp.asarray(xi), rate, stages)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(integ.numpy(), np.asarray(rinteg))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(rcomb))
    # float samples: the combs subtract integrator values that grow far past
    # the output's R^N gain, so the error is a few float32 ulps of the last
    # integrator's largest value (measured 5.3e-7 of it): XLA's float32 cumsum
    # against torch's
    xf = rng.standard_normal(400).astype(np.float32)
    y, _ = filters.cic_decimator(_t(xf), rate, stages)
    ry, _ = ref_filters.cic_decimator(jnp.asarray(xf), rate, stages)
    v = xf.astype(np.float64)
    for _ in range(stages):
        v = np.cumsum(v)
    assert np.max(np.abs(y.numpy() - np.asarray(ry))) < CIC_TOL * np.max(np.abs(v))


@pytest.mark.parametrize("length", [1, 2, 4, 5, 8, 9])
def test_median_filter_odd_and_even(length):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_array_equal(filters.median_filter(_t(x), length).numpy(),
                                  np.asarray(ref_filters.median_filter(jnp.asarray(x), length)))


# ---------------------------------------------------------------- measure


def test_spectra():
    rng = np.random.default_rng(6)
    x = _iq(rng, 2, 1000)
    for kw in ({}, {"nfft": 2048, "window": "hamming", "sample_rate": 1e3}):
        assert _rel(measure.periodogram_psd(_t(x), **kw),
                    ref_measure.periodogram_psd(jnp.asarray(x), **kw)) < FFT_TOL
    for kw in ({}, {"nperseg": 128, "overlap": 0.75, "window": "blackman", "sample_rate": 8e3}):
        assert _rel(measure.welch_psd(_t(x), **kw),
                    ref_measure.welch_psd(jnp.asarray(x), **kw)) < FFT_TOL
    for nfft, hop in ((256, None), (64, 16), (2048, None)):
        assert _rel(measure.stft(_t(x), nfft, hop), ref_measure.stft(jnp.asarray(x), nfft, hop)) \
            < FFT_TOL
    for k, n in ((5, None), (17, 500)):
        assert _rel(measure.goertzel_power(_t(x), k, n),
                    ref_measure.goertzel_power(jnp.asarray(x), k, n)) < FFT_TOL


def test_capacity_eye_power_and_noise_figures():
    snr = np.linspace(-10, 30, 9).astype(np.float32)
    assert _rel(measure.channel_capacity_awgn(_t(snr), 1e6),
                ref_measure.channel_capacity_awgn(jnp.asarray(snr), 1e6)) < 1e-6
    rng = np.random.default_rng(7)
    x = _iq(rng, 600)
    for sps, n, span in ((8, 64, 2), (4, 10, 3), (8, 200, 2)):
        np.testing.assert_array_equal(measure.eye_diagram(_t(x), sps, n, span).numpy(),
                                      np.asarray(ref_measure.eye_diagram(jnp.asarray(x), sps,
                                                                         n, span)))
    assert measure.eye_diagram(_t(x[:10]), 8).shape == (0, 16)
    assert _rel(measure.signal_power_db(_t(x)), ref_measure.signal_power_db(jnp.asarray(x))) < 1e-6
    assert measure.noise_figure_db(10.0, 75.0) == ref_measure.noise_figure_db(10.0, 75.0)
    stages = [(20.0, 1.5), (-3.0, 3.0), (15.0, 6.0)]
    assert measure.cascade_noise_figure_db(stages) == ref_measure.cascade_noise_figure_db(stages)


@pytest.mark.parametrize("wavelet,levels,n", [("haar", 1, 64), ("haar", 3, 101),
                                              ("db2", 2, 128), ("db4", 3, 256), ("db4", 5, 40)])
def test_wavelets(wavelet, levels, n):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, n)).astype(np.float32)
    got = measure.dwt(_t(x), wavelet, levels)
    want = ref_measure.dwt(jnp.asarray(x), wavelet, levels)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) < WAVELET_TOL
    assert _rel(measure.idwt(got, wavelet), ref_measure.idwt(want, wavelet)) < WAVELET_TOL
    noisy = (np.sin(np.arange(n) / 5.0) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    for thr in (None, 0.2):
        assert _rel(measure.dwt_denoise(_t(noisy), wavelet, levels, thr),
                    ref_measure.dwt_denoise(jnp.asarray(noisy), wavelet, levels, thr)) \
            < WAVELET_TOL


def test_unknown_wavelet_raises():
    with pytest.raises(ValueError):
        measure.dwt(torch.zeros(8), "sym5")


def test_moving_statistics():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    for length in (1, 8, 33):
        assert _rel(measure.moving_variance(_t(x), length),
                    ref_measure.moving_variance(jnp.asarray(x), length)) < 1e-5
        lo, hi = measure.moving_minmax(_t(x), length)
        rlo, rhi = ref_measure.moving_minmax(jnp.asarray(x), length)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    xc = _iq(rng, 2, 300)
    for length, lag in ((16, 1), (5, 7), (300, 1)):
        assert _rel(measure.moving_autocorrelation(_t(xc), length, lag),
                    ref_measure.moving_autocorrelation(jnp.asarray(xc), length, lag)) < STAT_TOL


def test_constellation_quality_and_sounding():
    rng = np.random.default_rng(10)
    s = (_iq(rng, 4000) * 0.6).astype(np.complex64)
    for bins, extent in ((64, 1.5), (17, 1.0)):
        np.testing.assert_array_equal(
            measure.constellation_persistence(_t(s), bins, extent).numpy(),
            np.asarray(ref_measure.constellation_persistence(jnp.asarray(s), bins, extent)))
    ref = np.exp(1j * np.pi / 2 * rng.integers(0, 4, 1000)).astype(np.complex64)
    rx = (ref + 0.1 * _iq(rng, 1000)).astype(np.complex64)
    got = measure.signal_quality(_t(rx), _t(ref))
    want = ref_measure.signal_quality(jnp.asarray(rx), jnp.asarray(ref))
    assert set(got) == set(want)
    for key in got:
        assert _rel(got[key], want[key]) < 1e-5, key
    probe = np.sign(rng.standard_normal(255)).astype(np.complex64)
    h = np.asarray([1.0, 0.5j, -0.2], np.complex64)
    rx = np.convolve(np.tile(probe, 2), h)[255:510].astype(np.complex64)
    for taps in (8, 32):
        assert _rel(measure.channel_sound(_t(rx), _t(probe), taps),
                    ref_measure.channel_sound(jnp.asarray(rx), jnp.asarray(probe), taps)) \
            < FFT_TOL


# ------------------------------------------- the reference's own tests


_OPS = {"filters": "r4w_tpu_torch.ops.filters", "pulse": "r4w_tpu_torch.ops.pulse",
        "measure": "r4w_tpu_torch.ops.measure"}


@pytest.mark.parametrize("name", [
    "test_fir_matches_numpy_convolve", "test_fir_streaming_equals_oneshot",
    "test_iir_single_pole_impulse_response", "test_iir_biquad_matches_scipy_style",
    "test_dc_blocker_removes_dc", "test_cic_decimator_dc_gain", "test_design_lowpass_response",
    "test_median_filter_rejects_impulse", "test_moving_average",
    "test_design_equiripple_matches_parks_mcclellan",
    "test_rrc_cascade_is_nyquist", "test_shape_symbols_peaks_at_symbols",
    "test_gaussian_taps_unit_area",
    "test_evm_and_m2m4_snr", "test_ber_confidence_interval", "test_welch_psd_tone",
    "test_goertzel_matches_fft", "test_theoretical_ber_curves",
])
def test_reference_ops_tests_on_the_port(monkeypatch, name):
    """tests/test_ops.py's filter, pulse and measure tests, their bars
    applied to the port's outputs."""
    run_reference_test(monkeypatch, "test_ops", name, **_OPS)
