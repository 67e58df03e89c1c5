"""The rest of `ops.filters2` against the JAX package.

Each function gets the inputs of its JAX test (tests/test_filters2.py) on
both sides, made from the same seeds in numpy: floats within TOL of the
largest reference magnitude, decisions equal. The reference's own test
functions also run on the port's module, and the block table is the
reference's. The envelope follower and the noise gate's gain run on the
recursion (kind ``attack_release``) and equal JAX bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import filters as ref_filters
from r4w_tpu.ops import filters2 as ref_f2
from r4w_tpu_torch.ops import filters2 as f2
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5         # float32 arithmetic in another order (FFTs, FIR sums, libm)
FFT_SUM_TOL = 2e-5  # overlap-add's tails summed after an FFT of another length's rounding


def _rand(n, seed=0, cplx=True):
    rng = np.random.default_rng(seed)
    if cplx:
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return rng.standard_normal(n).astype(np.float32)


FS = 10_000.0
T = np.arange(8192) / FS
XLAT = (np.exp(2j * np.pi * 2000 * T) + np.exp(2j * np.pi * -3000 * T)).astype(np.complex64)
TEMPLATES = _rand(256, 4).reshape(4, 64)
MF = np.zeros(512, np.complex64)
MF[100:164] = TEMPLATES[2]
IMPULSE = _rand(1024, 2) * np.float32(0.1)
IMPULSE[500] = 50.0
# a tone in noise: on a bare tone the other bins hold only the transforms' rounding
TONE = (np.exp(2j * np.pi * 128 * np.arange(4096) / 1024.0) + 0.1 * _rand(4096, 8)).astype(
    np.complex64)

CASES = [
    ("overlap_save", (_rand(1000), np.asarray(ref_filters.design_lowpass(31, 0.1, 1.0))), {}, TOL),
    ("overlap_save", (_rand(3000, 1, False), _rand(40, 2, False)), {"block": 64}, TOL),
    ("overlap_add", (_rand(777, cplx=False), _rand(32, 1, False)), {"block": 128}, FFT_SUM_TOL),
    ("overlap_add", (_rand(1000), _rand(100, 3, False)), {"block": 64}, FFT_SUM_TOL),
    ("frequency_xlating_fft_filter", (XLAT, np.asarray(ref_filters.design_lowpass(101, 500.0, FS)),
                                      2000.0, FS), {"decim": 4}, TOL),
    ("matched_filter_bank", (MF, TEMPLATES), {}, TOL),
    ("sparse_fir_filter", (np.arange(10, dtype=np.float32), [1.0, 0.5], [0, 2]), {}, 0.0),
    ("lagrange_interpolate", (np.arange(32, dtype=np.float32), 0.5), {"order": 3}, TOL),
    ("mmse_interpolate", (np.cos(2 * np.pi * 5 * np.arange(256) / 100.0).astype(np.float32), 0.5),
     {"n_taps": 8}, TOL),
    ("interpolating_resampler", (np.exp(2j * np.pi * 100 * np.arange(2048) / 1000.0)
                                 .astype(np.complex64), 2.0), {}, TOL),
    ("interpolating_resampler", (_rand(500, 5, False), 1.37), {}, TOL),
    ("sample_rate_converter", (_rand(1000), 48_000.0, 24_000.0), {}, TOL),
    ("sample_rate_converter", (_rand(1000), 48_000.0, 24_000.0 / 1.0007), {}, TOL),
    ("digital_up_converter", (np.ones(256, np.complex64), 4, 2000.0, 8000.0), {}, TOL),
    ("variable_rate_cic", (np.ones(64, np.float32), 4), {"stages": 3, "interp": True}, TOL),
    # integer samples: every integrator sum is exact in float32 (CIC_TOL of
    # test_torch_pulse_filters_measure.py covers float samples)
    ("variable_rate_cic", (np.round(4 * _rand(64, 6)).astype(np.complex64), 4), {"stages": 3}, 0.0),
    ("frequency_domain_oversampled_dft", (np.exp(2j * np.pi * 0.1253 * np.arange(128))
                                          .astype(np.complex64), 128), {"oversample": 8}, TOL),
    ("log_power_fft", (TONE,), {"nfft": 1024}, TOL),
    ("welch_periodogram", (_rand(4096),), {"nfft": 256}, TOL),
    ("instantaneous_frequency", (np.exp(2j * np.pi * 123 * np.arange(512) / 1000.0)
                                 .astype(np.complex64), 1000.0), {}, TOL),
    ("noise_blanker", (IMPULSE,), {}, TOL),
    ("noise_gate", (np.concatenate([np.full(300, 0.001), np.full(300, 1.0)]).astype(np.float32),),
     {"open_db": -20.0}, 0.0),
    ("noise_gate", (_rand(2000, 7) * np.float32(0.3),), {"open_db": -10.0, "close_db": -14.0,
                                                         "state": 0.5}, 0.0),
    ("noise_shaping_quantize", ((0.5 * np.sin(2 * np.pi * 0.01 * np.arange(8192)))
                                .astype(np.float32), 4), {}, TOL),
    ("noise_shaping_quantize", ((0.5 * np.sin(2 * np.pi * 0.01 * np.arange(4096)))
                                .astype(np.float32), 3), {"order": 2}, TOL),
    ("dynamic_range_compressor", (np.concatenate([np.full(2000, 0.05), np.full(2000, 1.0)])
                                  .astype(np.float32),), {"threshold_db": -20.0, "ratio": 4.0},
     TOL),
    ("multiband_compressor", (_rand(4096, cplx=False), 48_000.0), {}, TOL),
]


@pytest.mark.parametrize("name,args,kwargs,tol", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_filters2_against_jax(name, args, kwargs, tol):
    check_parity(getattr(f2, name), getattr(ref_f2, name), args, kwargs, tol, name)


def test_rrc_bank_picks_the_reference_rolloff():
    rng = np.random.default_rng(1)
    syms = (2 * rng.integers(0, 2, 256) - 1).astype(np.float32)
    from r4w_tpu.ops import pulse as ref_pulse
    taps = ref_pulse.root_raised_cosine_taps(4, 8, 0.35)
    tx = np.asarray(ref_pulse.shape_symbols(jnp.asarray(syms), taps, 4)).astype(np.complex64)
    check_parity(lambda x: f2.rrc_matched_filter_bank(x, 4, (0.1, 0.35, 0.9)),
                 lambda x: ref_f2.rrc_matched_filter_bank(x, 4, (0.1, 0.35, 0.9)), (tx,))


@pytest.mark.parametrize("args", [(3, 0.0), (3, 0.5), (5, 0.25)])
def test_tap_designs_equal_the_reference(args):
    np.testing.assert_array_equal(f2.lagrange_interpolator_taps(*args),
                                  np.asarray(ref_f2.lagrange_interpolator_taps(*args)))
    np.testing.assert_array_equal(f2.mmse_interpolator_taps(args[1]),
                                  np.asarray(ref_f2.mmse_interpolator_taps(args[1])))


def test_group_delay_and_synthesis_designs():
    for delay in (np.full(16, 0.0), np.linspace(0.0, 3.0, 16)):
        got = f2.group_delay_equalizer_taps(delay, n_taps=31)
        want = np.asarray(ref_f2.group_delay_equalizer_taps(delay, n_taps=31))
        assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))
    for kind, f_2 in (("lowpass", None), ("highpass", None), ("bandpass", 0.2), ("bandstop", 0.2)):
        np.testing.assert_array_equal(f2.filter_synthesis(kind, 63, 1.0, 0.1, f_2),
                                      np.asarray(ref_f2.filter_synthesis(kind, 63, 1.0, 0.1, f_2)))
    with pytest.raises(ValueError):
        f2.filter_synthesis("bandpass", 63, 1.0, 0.1)
    assert f2.BLOCKS == ref_f2.BLOCKS


@pytest.mark.parametrize("attack,release", [(0.1, 0.005), (0.5, 0.01)])
def test_envelope_follower_equals_jax_bit_for_bit(attack, release):
    mag = np.abs(_rand(5000, 11)).astype(np.float32)
    got, final = f2._env_follow(torch.from_numpy(mag), attack, release, 0.3)
    want, rfinal = ref_f2._env_follow(jnp.asarray(mag), attack, release, 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(final) == float(rfinal)


def test_envelope_follower_carries_one_state_a_row():
    mag = np.abs(_rand(900, 12)).reshape(3, 300).astype(np.float32)
    got, final = f2._env_follow(torch.from_numpy(mag), 0.2, 0.01, torch.tensor([0.0, 1.0, 2.0]))
    for row, y0 in enumerate((0.0, 1.0, 2.0)):
        want, _ = ref_f2._env_follow(jnp.asarray(mag[row]), 0.2, 0.01, y0)
        np.testing.assert_array_equal(got[row].numpy(), np.asarray(want))
    assert final.shape == (3,)


REFERENCE_TESTS = [
    "TestBlockConvolution.test_overlap_save_matches_direct_fir",
    "TestBlockConvolution.test_overlap_add_matches_numpy_convolve",
    "TestBlockConvolution.test_freq_xlating_fft_filter_extracts_channel",
    "TestMatchedBanks.test_matched_filter_bank_picks_template",
    "TestMatchedBanks.test_rrc_bank_identifies_rolloff", "TestMatchedBanks.test_sparse_fir",
    "TestInterpolators.test_lagrange_taps_integer_delay",
    "TestInterpolators.test_lagrange_half_sample_on_line",
    "TestInterpolators.test_mmse_interp_delays_tone",
    "TestInterpolators.test_interpolating_resampler_tone_freq",
    "TestInterpolators.test_sample_rate_converter_len", "TestInterpolators.test_duc_places_carrier",
    "TestInterpolators.test_variable_rate_cic_roundtrip_dc",
    "TestSpectral.test_group_delay_equalizer_flat_is_delay",
    "TestSpectral.test_log_power_fft_finds_tone", "TestSpectral.test_oversampled_dft_resolution",
    "TestSpectral.test_welch_alias_runs", "TestSpectral.test_instantaneous_frequency",
    "TestNoise.test_noise_blanker_kills_impulse", "TestNoise.test_noise_gate",
    "TestNoise.test_noise_shaping_quantizer_pushes_noise_up",
    "TestCompressors.test_compressor_reduces_loud", "TestCompressors.test_multiband_runs",
    "TestEmphasis.test_pre_de_emphasis_roundtrip", "TestEmphasis.test_fm_deemphasis_attenuates_highs",
    "TestSynthesis.test_filter_synthesis_kinds",
]


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_reference_filters2_tests_on_the_port(monkeypatch, name):
    run_reference_test(monkeypatch, "test_filters2", name, flt="r4w_tpu_torch.ops.filters",
                       f2="r4w_tpu_torch.ops.filters2",
                       **{"r4w_tpu.ops.pulse": "r4w_tpu_torch.ops.pulse"})
