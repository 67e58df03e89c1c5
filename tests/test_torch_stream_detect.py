"""`ops.stream_math` and `ops.detect` against the JAX package.

Each function gets the inputs of its JAX test (tests/test_detect_streammath.py)
on both sides, made from the same seeds in numpy: hard decisions (bits,
masks, indices, codes) equal, floats within TOL of the largest reference
magnitude. The reference's own test functions also run on the port's
modules (`torch_port_proxy.run_reference_test`). The parallel hysteresis
(`threshold_block`, `burst_detect`) is held against a numpy step loop on
random inputs, `hi == lo` included.
"""

import numpy as np
import pytest
import torch

from r4w_tpu.ops import detect as ref_detect
from r4w_tpu.ops import stream_math as ref_sm
from r4w_tpu_torch.ops import detect, stream_math as sm
from torch_port_proxy import check_parity, run_reference_test

TOL = 1e-5        # float32 arithmetic in another order (FFTs, sums, libm)
SCAN_TOL = 1e-4   # float32 step loops whose per-step rounding XLA may fuse (CUSUM)


def _cplx(rng, n, scale=1.0) -> np.ndarray:
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale * np.sqrt(0.5)
            ).astype(np.complex64)


def _burst_input(seed=0) -> np.ndarray:
    x = _cplx(np.random.default_rng(seed), 8192, 0.05)
    x[1024:2048] += 2.0
    x[5120:6144] += 2.0
    return x


R = np.random.default_rng(5)
X256 = _cplx(R, 256)
PCM = (8000 * np.sin(2 * np.pi * 0.01 * np.arange(2000))).astype(np.int32)

STREAM_MATH_CASES = [
    ("complex_to_mag_phase", (X256,), {}),
    ("mag_phase_to_complex", (np.abs(X256).astype(np.float32), np.angle(X256).astype(np.float32)),
     {}),
    ("complex_to_arg", (X256,), {}),
    ("complex_normalize", (X256,), {}),
    ("complex_to_interleaved", (X256,), {}),
    ("interleaved_to_complex", (R.standard_normal(200).astype(np.float32),), {}),
    ("char_to_float", (R.integers(-128, 128, 64).astype(np.int32),), {}),
    ("float_to_char", (R.uniform(-1.2, 1.2, 100).astype(np.float32),), {}),
    ("stream_add", (R.standard_normal(32).astype(np.float32),
                    R.standard_normal(32).astype(np.float32)), {}),
    ("stream_multiply", (X256, X256[::-1].copy()), {}),
    ("stream_abs", (X256,), {}),
    ("stream_conjugate", (X256,), {}),
    ("argmax_block", (R.standard_normal((3, 40)).astype(np.float32),), {}),
    ("bin_statistics", (np.arange(12, dtype=np.float32), 3), {}),
    ("threshold_block", (np.asarray([0.0, 0.9, 1.1, 0.7, 0.3, 1.2, 0.0], np.float32), 0.5),
     {"hi": 1.0}),
    ("signal_clipper", (np.asarray([3 + 4j, 0.1 + 0.1j], np.complex64), 1.0), {}),
    ("signal_clipper", (R.standard_normal(64).astype(np.float32), 0.5), {}),
    ("binary_slicer", (X256,), {}),
    ("pack_bits", (R.integers(0, 2, 64).astype(np.int32), 8), {}),
    ("pack_bits", (R.integers(0, 2, 64).astype(np.int32), 8), {"msb_first": False}),
    ("unpack_bits", (R.integers(0, 256, 8).astype(np.int32), 8), {}),
    ("uniform_quantize", (R.uniform(-1, 1, 100_000).astype(np.float32), 8), {}),
    ("sigma_delta_modulate", (np.full(4096, 0.25, np.float32),), {}),
    ("mu_law_encode", (np.linspace(-1, 1, 101).astype(np.float32),), {}),
    ("mu_law_decode", (np.linspace(-1, 1, 101).astype(np.float32),), {}),
    ("adpcm_encode", (PCM,), {}),
    ("burst_shape", (np.exp(2j * np.pi * 0.1 * np.arange(2048)).astype(np.complex64),),
     {"ramp": 128}),
]


@pytest.mark.parametrize("name,args,kwargs", STREAM_MATH_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(STREAM_MATH_CASES)])
def test_stream_math_against_jax(name, args, kwargs):
    check_parity(getattr(sm, name), getattr(ref_sm, name), args, kwargs, TOL, name)


def test_adpcm_decode_against_jax():
    nib, state = ref_sm.adpcm_encode(PCM)
    nib = np.asarray(nib)
    check_parity(sm.adpcm_decode, ref_sm.adpcm_decode, (nib,), {}, 0.0, "adpcm_decode")
    check_parity(lambda n: sm.adpcm_decode(n, (100, 20)), lambda n: ref_sm.adpcm_decode(
        n, (100, 20)), (nib[:300],), {}, 0.0, "adpcm_decode state")


DETECT_CASES = [
    ("frame_energy_db", (_burst_input(),), {"frame": 256}, TOL),
    ("energy_detect", (_burst_input(),), {"frame": 256}, TOL),
    ("burst_detect", (_burst_input(),), {"frame": 64}, TOL),
    ("burst_detect", (np.stack([_burst_input(1), _burst_input(2)]),), {"frame": 64}, TOL),
    ("zero_crossing_rate", (np.sin(2 * np.pi * 0.45 * np.arange(4096)).astype(np.float32),), {},
     TOL),
    ("voice_activity", (np.concatenate([0.02 * R.standard_normal(4096), np.sin(
        2 * np.pi * 0.02 * np.arange(4096)) + 0.02 * R.standard_normal(4096),
        0.02 * R.standard_normal(8192)]).astype(np.float32), 256), {}, TOL),
    ("squelch", (_burst_input(3),), {"frame": 64}, TOL),
    ("sync_word_correlate", (np.concatenate([np.zeros(37, np.int32), [1, 0, 1, 1, 0, 0, 1, 0],
                                             np.ones(20, np.int32)]).astype(np.int32),
                             np.asarray([1, 0, 1, 1, 0, 0, 1, 0], np.int32)), {}, TOL),
    ("teager_kaiser", ((2.0 * np.cos(0.3 * np.arange(2048))).astype(np.float32),), {}, TOL),
    ("teager_kaiser", (X256,), {}, TOL),
    ("spectral_kurtosis", (_cplx(R, 65536), 256), {}, TOL),
    ("spectrum_sense", ((_cplx(R, 65536, 0.1) + np.exp(2j * np.pi * 0.1 * np.arange(65536))
                         ).astype(np.complex64),), {"nfft": 256}, TOL),
    ("cusum_changepoint", (np.r_[R.standard_normal(600), R.standard_normal(400) + 3.0]
                           .astype(np.float32),), {}, SCAN_TOL),
]


@pytest.mark.parametrize("name,args,kwargs,tol", DETECT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(DETECT_CASES)])
def test_detect_against_jax(name, args, kwargs, tol):
    check_parity(getattr(detect, name), getattr(ref_detect, name), args, kwargs, tol, name)


def test_sync_word_detect_and_host_helpers_against_jax():
    word = np.asarray([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
    bits = np.concatenate([np.zeros(37, np.int32), word, np.ones(20, np.int32)])
    bits[40] ^= 1
    for errors in (0, 1):
        check_parity(lambda b, w: detect.sync_word_detect(b, w, errors),
                     lambda b, w: ref_detect.sync_word_detect(b, w, errors), (bits, word))
    mask = np.array(ref_detect.burst_detect(_burst_input(), 64))
    for got, want in zip(detect.burst_edges(torch.from_numpy(mask)), ref_detect.burst_edges(mask)):
        np.testing.assert_array_equal(got, want)
    occ = np.array(ref_detect.spectrum_sense(_cplx(R, 8192), 128)[0])
    occ[10:30] = False
    assert detect.spectrum_holes(torch.from_numpy(occ), 4) == ref_detect.spectrum_holes(occ, 4)


def _threshold_loop(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    state, out = np.zeros(x.shape[:-1], np.float32), np.empty_like(x)
    for t in range(x.shape[-1]):
        state = np.where(x[..., t] >= np.float32(hi), 1.0,
                         np.where(x[..., t] <= np.float32(lo), 0.0, state)).astype(np.float32)
        out[..., t] = state
    return out


@pytest.mark.parametrize("lo,hi", [(0.0, 0.0), (-0.3, 0.4), (0.5, 0.5), (1.0, -1.0)])
def test_parallel_hysteresis_equals_the_step_loop(lo, hi):
    x = np.random.default_rng(8).standard_normal((3, 2000)).astype(np.float32)
    x[0, 100:200] = np.float32(hi)  # values on the thresholds themselves
    x[1, 300:400] = np.float32(lo)
    got = sm.threshold_block(torch.from_numpy(x), lo, hi).numpy()
    np.testing.assert_array_equal(got, _threshold_loop(x, lo, hi))


@pytest.mark.parametrize("on_db,off_db", [(10.0, 6.0), (3.0, 3.0), (2.0, 5.0)])
def test_burst_gate_equals_the_reference_scan(on_db, off_db):
    """The parallel form where the open level is above the close level; the
    scan itself (a frame both above and below toggles) otherwise."""
    x = np.stack([_burst_input(4), _cplx(np.random.default_rng(9), 8192)])
    got = detect.burst_detect(torch.from_numpy(x), 64, on_db, off_db).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_detect.burst_detect(x, 64, on_db, off_db)))


def test_median_floor_averages_the_middle_frames():
    e = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert float(detect._median(e)) == 2.5


REFERENCE_TESTS = [
    "TestDetectors.test_energy_detect_burst", "TestDetectors.test_burst_hysteresis_and_edges",
    "TestDetectors.test_zero_crossing_rate", "TestDetectors.test_voice_activity",
    "TestDetectors.test_squelch_gates_noise", "TestDetectors.test_sync_word_detect",
    "TestDetectors.test_teager_kaiser_tone_energy",
    "TestDetectors.test_spectral_kurtosis_flags_impulsive_bin",
    "TestDetectors.test_spectrum_sense_and_holes", "TestDetectors.test_cusum_changepoint",
    "TestStreamMath.test_mag_phase_roundtrip", "TestStreamMath.test_normalize_and_conjugate",
    "TestStreamMath.test_interleaved_roundtrip", "TestStreamMath.test_pack_unpack_bits",
    "TestStreamMath.test_threshold_hysteresis", "TestStreamMath.test_clipper_preserves_phase",
    "TestStreamMath.test_quantizer_snr", "TestStreamMath.test_sigma_delta_tracks_mean",
    "TestStreamMath.test_mu_law_roundtrip_and_companding_gain",
    "TestStreamMath.test_adpcm_roundtrip_snr", "TestStreamMath.test_vco_frequency",
    "TestStreamMath.test_ddc_extracts_channel", "TestStreamMath.test_bin_statistics",
]


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_reference_detect_streammath_tests_on_the_port(monkeypatch, name):
    run_reference_test(monkeypatch, "test_detect_streammath", name,
                       detect="r4w_tpu_torch.ops.detect", sm="r4w_tpu_torch.ops.stream_math")


def test_reference_burst_shape_test_on_the_port(monkeypatch):
    run_reference_test(monkeypatch, "test_detect_streammath", "test_burst_shape_reduces_splatter",
                       **{"r4w_tpu.ops.stream_math": "r4w_tpu_torch.ops.stream_math"})
