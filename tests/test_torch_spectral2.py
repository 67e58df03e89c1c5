"""`ops.spectral2` against the JAX package.

The reference's own tests (tests/test_spectral2.py and the spectral2 cases
of the known-answer files) run on the port through `torch_port_proxy`.
Parity cases hold each function against the reference on the same numpy
inputs: decisions equal, floats within TOL of the largest reference
magnitude (FFTs and sums in another order), LOOP_TOL for the EM loop's 50
float32 steps. The SVD-based functions are held by what is unique:
U·S·Vᴴ for `matrix_complete_svt`, singular values and the reconstruction
for `hosvd`, column norms and Q·Qᴴ for `past_subspace_track`. The traps of
the module have tests of their own: EMD's sliding extrema equal to the
reference's gather bit for bit, the reassignment's scatter order with many
contributions on one bin, the quantile beyond torch's 2^24-element limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import spectral2 as ref
from r4w_tpu_torch.ops import spectral2 as sp
from torch_port_proxy import check_parity, compare, run_reference_test

TOL = 1e-5
CAF_TOL = 1e-4    # R_α(τ): means of 2^16 products, a matrix product against JAX's reduction
LOOP_TOL = 1e-4   # 50 EM steps of float32 sums in another order
SVD_TOL = 1e-4    # products of cuSOLVER/LAPACK factors against JAX's

SP2 = "r4w_tpu_torch.ops.spectral2"
SP2_REF = {"r4w_tpu.ops.spectral2": SP2}

REFERENCE_TESTS = [
    *[("test_spectral2", n, {}, {"sp": SP2}) for n in (
        "TestCyclo.test_cyclic_autocorr_bpsk_symbol_rate",
        "TestCyclo.test_spectral_correlation_shape",
        "TestCyclo.test_bispectrum_detects_quadratic_coupling",
        "TestEmdProny.test_emd_separates_scales", "TestEmdProny.test_prony_recovers_damped_tone",
        "TestEmdProny.test_modal_analysis", "TestReassign.test_reassignment_sharpens_tone",
        "TestStats.test_spectral_entropy_extremes", "TestStats.test_power_law_fit",
        "TestStats.test_plv", "TestStats.test_em_gmm_recovers_modes",
        "TestStats.test_matrix_completion_low_rank", "TestStats.test_hosvd_reconstructs",
        "TestStats.test_past_tracks_dominant_subspace",
        "TestImageTools.test_anomaly_score_flags_new_emitter",
        "TestImageTools.test_waterfall_enhance_range", "TestImageTools.test_time_raster")],
    *[("test_known_answers_r4k", n, SP2_REF, {}) for n in (
        "TestCyclicAutocorrelation.test_pure_tone_is_not_cyclostationary",
        "TestCyclicAutocorrelation.test_am_cycle_feature_amplitude",
        "TestSpectralCorrelation.test_two_tone_separation_feature",
        "TestSpectralEntropy.test_tone_entropy_zero_noise_entropy_one",
        "TestSpectralEntropy.test_two_equal_tones_entropy",
        "TestPowerLawFit.test_recovers_synthesized_exponent",
        "TestPhaseLockingValue.test_constant_offset_is_unity",
        "TestPhaseLockingValue.test_gaussian_jitter_law",
        "TestPhaseLockingValue.test_independent_phases_vanish",
        "TestEmGmm1d.test_two_separated_gaussians",
        "TestMatrixCompletion.test_rank1_missing_entries_recovered",
        "TestHosvd.test_tucker_exact_reconstruction_and_all_orthogonality",
        "TestPastSubspace.test_rank1_stream_converges_to_signal_direction",
        "TestReassignedSpectrogram.test_tone_energy_concentrates_to_one_bin",
        "TestEmdSeparation.test_fast_tone_rides_first_imf_trend_in_residue",
        "TestModalFrequencies.test_damped_mode_frequency_and_zeta")],
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    run_reference_test(monkeypatch, module, name, modules, **swaps)


def _cplx(rng, *shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(
        np.complex64)


def _bpsk(rng, n_sym, sps):
    return np.repeat(2.0 * rng.integers(0, 2, n_sym) - 1.0, sps).astype(np.complex64)


def _cases():
    r = np.random.default_rng(16)
    bpsk = _bpsk(r, 1024, 4) + 0.3 * _cplx(r, 4096)
    tone = np.exp(2j * np.pi * 0.11 * np.arange(4096)).astype(np.complex64) + 0.2 * _cplx(r, 4096)
    real = r.standard_normal(4096).astype(np.float32)
    t = np.arange(2048)
    qpc = (np.cos(0.3 * t) + np.cos(0.5 * t) + np.cos(0.8 * t)).astype(np.float32)
    emd_x = (np.sin(2 * np.pi * 0.2 * t) + 0.5 * np.sin(2 * np.pi * 0.01 * t)).astype(np.float32)
    gmm = np.concatenate([r.normal(-2, 0.5, 500), r.normal(3, 1.0, 700)]).astype(np.float32)
    img = (r.standard_normal((40, 64)) + np.linspace(0, 3, 64)).astype(np.float32)
    return [
        ("cyclic_autocorrelation", lambda x: sp.cyclic_autocorrelation(x, [0.0, 0.25, 0.1], 4),
         lambda x: ref.cyclic_autocorrelation(x, [0.0, 0.25, 0.1], 4), (bpsk,), CAF_TOL),
        ("spectral_correlation", lambda x: sp.spectral_correlation(x, 128, 16),
         lambda x: ref.spectral_correlation(x, 128, 16), (bpsk,), TOL),
        ("spectral_correlation_short", lambda x: sp.spectral_correlation(x, 64, 8),
         lambda x: ref.spectral_correlation(x, 64, 8), (bpsk[:40],), TOL),
        ("bispectrum", lambda x: sp.bispectrum(x, 64), lambda x: ref.bispectrum(x, 64), (qpc,),
         TOL),
        ("emd", lambda x: sp.emd(x, 3, 4), lambda x: ref.emd(x, 3, 4), (emd_x,), 0.0),
        ("spectral_entropy", sp.spectral_entropy, ref.spectral_entropy, (tone,), TOL),
        ("power_law_fit", lambda x: sp.power_law_fit(x, 1.0, 256),
         lambda x: ref.power_law_fit(x, 1.0, 256), (np.cumsum(real).astype(np.float32),), TOL),
        ("phase_locking_value", sp.phase_locking_value, ref.phase_locking_value,
         (tone, bpsk), TOL),
        ("em_gmm_1d", sp.em_gmm_1d, ref.em_gmm_1d, (gmm,), LOOP_TOL),
        ("spectrogram_anomaly_score", sp.spectrogram_anomaly_score,
         ref.spectrogram_anomaly_score, (img,), TOL),
        ("waterfall_enhance", sp.waterfall_enhance, ref.waterfall_enhance, (img,), TOL),
        ("time_raster", lambda b: sp.time_raster(b, 7), lambda b: ref.time_raster(b, 7),
         (r.integers(0, 2, 100).astype(np.int32),), 0.0),
        ("reassigned_spectrogram", lambda x: sp.reassigned_spectrogram(x, 1.0, 64, 16),
         lambda x: ref.reassigned_spectrogram(x, 1.0, 64, 16), (tone[:1024],), TOL),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,port,want,args,tol", CASES, ids=[c[0] for c in CASES])
def test_parity(name, port, want, args, tol):
    check_parity(port, want, args, tol=tol, label=name)


def test_cyclic_autocorrelation_rows_are_blocks():
    """Leading rows: each row is the reference's call on that block."""
    r = np.random.default_rng(3)
    x = (_bpsk(r, 512, 4) + 0.5 * _cplx(r, 2048)).reshape(2, 1024)
    got = sp.cyclic_autocorrelation(torch.from_numpy(x), [0.25, 0.123], 4).numpy()
    for k in range(2):
        compare(got[k], ref.cyclic_autocorrelation(jnp.asarray(x[k]), [0.25, 0.123], 4), CAF_TOL)


def test_emd_sliding_extrema_equal_the_gather():
    """At n = 2048 the window is 65 samples: the pooled max and min equal the
    reference's clamped (n, w) gather bit for bit, and so does every IMF."""
    r = np.random.default_rng(5)
    h = r.standard_normal(2048).astype(np.float32)
    w = max(3, h.shape[0] // 32) | 1
    assert w > 3
    half = w // 2
    idx = np.clip(np.arange(h.shape[0])[:, None] + np.arange(-half, half + 1)[None, :], 0,
                  h.shape[0] - 1)
    hi, lo = sp.sliding_extrema(torch.from_numpy(h), w)
    np.testing.assert_array_equal(hi.numpy(), h[idx].max(-1))
    np.testing.assert_array_equal(lo.numpy(), h[idx].min(-1))
    np.testing.assert_array_equal(sp.emd(torch.from_numpy(h)).numpy(), np.asarray(ref.emd(h)))


def test_reassignment_sums_in_source_order():
    """`ordered_bin_sum` adds each bin's terms in source order, a float32 sum
    from zero as the reference's scatter-add on the CPU: equal bit for bit
    to a sequential loop with many terms on one bin, where a sum in another
    order differs. A tone pulls most of a frame's bins onto one, and the
    spectrogram agrees with the reference's within TOL (its FFTs differ by
    ulps)."""
    r = np.random.default_rng(2)
    vals = (r.standard_normal((3, 200)) * 10.0 ** r.integers(-3, 4, (3, 200))).astype(np.float32)
    bins = r.integers(0, 5, (3, 200))
    want = np.zeros((3, 5), np.float32)
    for row in range(3):
        for v, b in zip(vals[row], bins[row]):
            want[row, b] = np.float32(want[row, b] + v)
    got = sp.ordered_bin_sum(torch.from_numpy(vals), torch.from_numpy(bins), 5).numpy()
    np.testing.assert_array_equal(got, want)
    out = sp.ordered_bin_sum(torch.tensor([[1e8, 1.0, -1e8, 1.0, 3.0]]),
                             torch.tensor([[2, 2, 2, 2, 0]]), 4)[0]
    assert out.tolist() == [3.0, 0.0, 1.0, 0.0]   # ((1e8 + 1) - 1e8) + 1 in float32
    n = 512
    x = np.exp(2j * np.pi * 0.2 * np.arange(n)).astype(np.complex64) + 0.01 * _cplx(r, n)
    check_parity(lambda v: sp.reassigned_spectrogram(v, 1.0, 64, 16),
                 lambda v: ref.reassigned_spectrogram(v, 1.0, 64, 16), (x,), tol=TOL)


def test_quantile_past_torch_limit():
    """Over 2^24 elements (torch.quantile refuses them) the percentile
    equals the reference's on the same input; an element's neighbour in
    sorted order, which the plain p / 100 · (n − 1) picks here, would not.
    Smaller, the percentile and quantile equal the reference's too: its
    compiled form folds 1/100 · (n − 1) and fuses the interpolation's
    second product. (The DSA gate's waterfall of 2^25 values is held on the
    card against the CPU.)"""
    r = np.random.default_rng(7)
    v = r.standard_normal((1 << 24) + 4099).astype(np.float32)
    assert float(sp.percentile(torch.from_numpy(v), 99.0)) == float(
        jnp.percentile(jnp.asarray(v), 99.0))
    del v
    small = r.standard_normal(5000).astype(np.float32)
    for m in (7, 100, 1001, 5000):
        for p in (1.0, 25.0, 50.0, 97.5, 99.0, 99.9):
            assert float(sp.percentile(torch.from_numpy(small[:m]), p)) == float(
                jnp.percentile(jnp.asarray(small[:m]), p)), (m, p)
    np.testing.assert_array_equal(
        sp.quantile(torch.from_numpy(small[:1001]), [0.1, 0.33, 0.5, 0.9]).numpy(),
        np.asarray(jnp.quantile(jnp.asarray(small[:1001]),
                                jnp.asarray([0.1, 0.33, 0.5, 0.9], jnp.float32))))


def test_svd_based_functions_by_what_is_unique():
    r = np.random.default_rng(9)
    truth = np.outer(r.standard_normal(12), r.standard_normal(10)).astype(np.float32)
    mask = (r.random((12, 10)) < 0.6).astype(np.float32)
    for rank in (1, None):
        got = sp.matrix_complete_svt(torch.from_numpy(truth * mask), torch.from_numpy(mask),
                                     rank=rank, n_iter=30)
        want = ref.matrix_complete_svt(truth * mask, mask, rank=rank, n_iter=30)
        compare(got, want, SVD_TOL)
    t = r.standard_normal((4, 5, 3)).astype(np.float32)
    core, factors = sp.hosvd(torch.from_numpy(t))
    rcore, rfactors = ref.hosvd(jnp.asarray(t))
    for mode in range(3):
        unf = np.moveaxis(t, mode, 0).reshape(t.shape[mode], -1)
        compare(np.linalg.svd(unf, compute_uv=False), np.linalg.svd(
            np.asarray(rfactors[mode]).T @ unf, compute_uv=False), SVD_TOL)
    rebuilt = core
    for mode, u in enumerate(factors):
        rebuilt = torch.movedim(torch.tensordot(u, torch.movedim(rebuilt, mode, 0), dims=1), 0,
                                mode)
    compare(rebuilt, t, SVD_TOL)
    compare(torch.linalg.svdvals(core.reshape(4, -1)), np.linalg.svd(
        np.asarray(rcore).reshape(4, -1), compute_uv=False), SVD_TOL)
    v = np.exp(1j * np.arange(6) * 0.7)
    stream = (np.outer(r.standard_normal(200), v) + 0.05 * _cplx(r, 200, 6)).astype(np.complex64)
    q, norms = sp.past_subspace_track(torch.from_numpy(stream), 1)
    rq, rnorms = ref.past_subspace_track(jnp.asarray(stream), 1)
    compare(norms, rnorms, SVD_TOL)
    rq = np.asarray(rq)
    compare(q @ q.mH, rq @ rq.conj().T, SVD_TOL)


def test_prony_is_the_reference_numpy():
    n = np.arange(64)
    x = (np.exp((-0.02 + 0.3j) * n) + 0.5 * np.exp((-0.01 - 0.7j) * n)).astype(np.complex64)
    for got, want in zip(sp.prony(torch.from_numpy(x), 2), ref.prony(x, 2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(sp.modal_frequencies(torch.from_numpy(x), 1000.0, 4),
                         ref.modal_frequencies(x, 1000.0, 4)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
