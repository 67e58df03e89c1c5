"""`ops.beamforming` and `ops.mimo` against the JAX package.

The reference's own test functions (tests/test_beamforming.py, the MIMO
tests of test_mimo_sova.py, and the array and MIMO parts of the
known-answer files) run on the port through `torch_port_proxy`.
`check_parity` covers what those tests do not, each with its tolerance:
floats within TOL of the largest reference magnitude, LOOP_TOL for the NLMS
step loops (float32 products over thousands of steps), SOLVE_TOL for the
LCMV null steering's ill-conditioned solve, decisions equal.
The traps: the pseudo-inverse's cut-off (``jnp.linalg.pinv``'s rtol, not
torch's), the SVD's phase-free invariants, ML ties, and the NLMS loops'
state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import beamforming as ref_bf
from r4w_tpu.ops import mimo as ref_mimo
from r4w_tpu_torch import convert
from r4w_tpu_torch.core import types
from r4w_tpu_torch.ops import beamforming as bf, mimo
from torch_port_proxy import check_parity, compare, run_reference_test

TOL = 1e-5
LOOP_TOL = 1e-4
SOLVE_TOL = 1e-3   # LCMV: a loaded covariance of condition ~10^4

BF, MIMO = "r4w_tpu_torch.ops.beamforming", "r4w_tpu_torch.ops.mimo"

REFERENCE_TESTS = [
    *[("test_beamforming", n, {}, {"bf": BF}) for n in (
        "TestMimoDetect.test_zf_and_mmse_recover_clean", "TestMimoDetect.test_ml_beats_zf_in_noise",
        "TestMimoDetect.test_svd_precoding_diagonalizes",
        "TestMimoDetect.test_spatial_multiplex_power",
        "TestOstbc.test_ostbc34_roundtrip_flat_channel", "TestNoma.test_noma_sic_roundtrip",
        "TestArrays.test_null_steering_pattern", "TestArrays.test_gsc_removes_interferer",
        "TestArrays.test_si_canceller_erle", "TestMmwaveRis.test_beam_search_finds_direction",
        "TestMmwaveRis.test_beam_steering_quantization", "TestMmwaveRis.test_ris_cophasing_gain",
        "TestMmwaveRis.test_oam_mode_orthogonality",
        "TestMmwaveRis.test_ultrasound_focus_and_das")],
    *[("test_mimo_sova", n, {}, {"mimo": MIMO}) for n in (
        "TestAlamouti.test_encode_structure", "TestAlamouti.test_decode_through_fading",
        "TestAlamouti.test_diversity_gain", "TestCombining.test_mrc_beats_selection_snr",
        "TestSic.test_two_user_separation", "TestWaterfilling.test_total_power_and_kkt",
        "TestWaterfilling.test_deep_fade_gets_nothing", "TestAdaptiveModcod.test_hysteresis_ladder",
        "TestUwbRanging.test_two_way_ranging", "TestUwbRanging.test_leading_edge_beats_argmax_in_nlos",
        "test_waterfilling_zero_power_allocates_nothing")],
    ("test_known_answers_r4d", "TestArrayClosedForms.test_delay_and_sum_coherent_vs_misaligned",
     {"r4w_tpu.ops.beamforming": BF}, {}),
    *[("test_known_answers_r4l", n, {"r4w_tpu.ops.mimo": MIMO}, {}) for n in (
        "TestAlamouti.test_orthogonal_design_and_exact_recovery",
        "TestAlamouti.test_noise_diversity_scaling", "TestDiversityCombiners.test_combiner_gain_laws",
        "TestDiversityCombiners.test_mrc_snr_is_sum_of_branch_snrs")],
    *[("test_known_answers_r4o", n, {"r4w_tpu.ops.beamforming": BF}, {}) for n in (
        "TestMimoDetectors.test_zf_and_mmse_exact_recovery",
        "TestMimoDetectors.test_ml_detection_exact_indices", "TestSvdPrecoding.test_diagonalizes_channel",
        "TestOstbc34.test_orthogonal_design_and_recovery")],
    ("test_known_answers_r4o", "TestTwrRange.test_closed_form", {"r4w_tpu.ops.mimo": MIMO}, {}),
    ("test_known_answers_r4p", "TestBeamSteering.test_conjugate_phases_give_coherent_array_gain",
     {"r4w_tpu.ops.beamforming": BF}, {}),
    ("test_known_answers_r4t", "TestGscCancel.test_interferer_suppressed_look_preserved",
     {"r4w_tpu.ops.beamforming": BF}, {}),
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    run_reference_test(monkeypatch, module, name, modules, **swaps)


def _cplx(rng, *shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(
        np.complex64)


QPSK = (np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4)))).astype(np.complex64)


def test_pinv_cut_off_is_the_references():
    """A 4 × 2 channel whose singular values are 1 and 2e-6: torch's default
    cut (max(m, n)·eps = 4.8e-7) keeps the small one and amplifies its noise
    5·10^5 times; ``jnp.linalg.pinv``'s (10·max(m, n)·eps = 4.8e-6) drops it.
    The port passes the reference's cut and equals it."""
    rng = np.random.default_rng(1)
    u, _ = np.linalg.qr(_cplx(rng, 4, 2))
    v, _ = np.linalg.qr(_cplx(rng, 2, 2))
    h = (u @ np.diag([1.0, 2e-6]) @ v.conj().T).astype(np.complex64)
    y = _cplx(rng, 50, 4)
    got = bf.mimo_detect_zf(torch.from_numpy(y), torch.from_numpy(h))
    compare(got, ref_bf.mimo_detect_zf(jnp.asarray(y), jnp.asarray(h)), TOL)
    careless = torch.from_numpy(y) @ torch.linalg.pinv(torch.from_numpy(h)).T
    assert float(torch.max(torch.abs(careless))) > 1e3 * float(torch.max(torch.abs(got)))


def test_svd_precoding_invariants():
    """Singular vectors are unique up to a phase a column: hold s, U·S·Vᴴ and
    the precoded link's decisions against the reference, not the vectors."""
    rng = np.random.default_rng(2)
    h = _cplx(rng, 4, 3)
    f, wh, s = bf.mimo_precode_svd(torch.from_numpy(h))
    rf, rwh, rs = ref_bf.mimo_precode_svd(jnp.asarray(h))
    compare(s, rs, TOL)
    recon = wh.mH @ torch.diag(s).to(torch.complex64) @ f.mH
    compare(recon, np.asarray(rwh).conj().T @ np.diag(np.asarray(rs)) @ np.asarray(rf).conj().T, TOL)
    idx = rng.integers(0, 4, (64, 3))
    rx = (QPSK[idx] @ f.numpy().T) @ h.T + 0.05 * _cplx(rng, 64, 4)
    eq = (rx.astype(np.complex64) @ wh.numpy().T) / s.numpy()
    d = np.argmin(np.abs(eq[..., None] - QPSK), axis=-1)
    np.testing.assert_array_equal(d, idx)


def test_ml_detection_ties_take_the_lower_index():
    """y at the midpoint of two candidates, equidistant in float32: both
    packages pick the lower combination."""
    h = np.eye(2, dtype=np.complex64)
    y = np.asarray([[0.0 + 0.70710677j, 0.70710677 + 0.70710677j]], np.complex64)
    check_parity(bf.mimo_detect_ml, ref_bf.mimo_detect_ml, (y, h, QPSK), {}, TOL, "ml tie")
    rng = np.random.default_rng(3)
    h = _cplx(rng, 2, 2)
    y = (QPSK[rng.integers(0, 4, (300, 2))] @ h.T + 0.3 * _cplx(rng, 300, 2)).astype(np.complex64)
    check_parity(bf.mimo_detect_ml, ref_bf.mimo_detect_ml, (y, h, QPSK), {}, TOL, "ml")


def test_nlms_loops_against_jax():
    rng = np.random.default_rng(4)
    tx = _cplx(rng, 1500)
    si = (0.9 * tx + 0.3 * np.roll(tx, 3)).astype(np.complex64)
    check_parity(bf.self_interference_cancel, ref_bf.self_interference_cancel, (si, tx),
                 {"n_taps": 8}, LOOP_TOL, "si")
    a_sig = np.exp(1j * np.pi * np.arange(8) * np.sin(np.deg2rad(0.0)))
    a_int = np.exp(1j * np.pi * np.arange(8) * np.sin(np.deg2rad(40.0)))
    t = np.arange(1000)
    x = (np.outer(a_sig, np.exp(2j * np.pi * 0.01 * t)) + 3 * np.outer(a_int, np.exp(
        2j * np.pi * 0.013 * t)) + 0.01 * _cplx(rng, 8, 1000)).astype(np.complex64)
    check_parity(bf.gsc_cancel, ref_bf.gsc_cancel, (x, 0.0), {}, LOOP_TOL, "gsc")


def test_array_blocks_against_jax(monkeypatch):
    monkeypatch.setattr(types, "DEFAULT_DEVICE", torch.device("cpu"))  # the designs' device
    rng = np.random.default_rng(5)
    check_parity(bf.null_steer_weights, ref_bf.null_steer_weights, (8, 5.0, [30.0, -45.0]), {},
                 SOLVE_TOL, "null steer")
    check_parity(bf.mmwave_beam_search, ref_bf.mmwave_beam_search, (_cplx(rng, 16),),
                 {"codebook_bits": 5}, TOL, "mmwave")
    check_parity(bf.delay_and_sum, ref_bf.delay_and_sum, (_cplx(rng, 4, 64), np.asarray(
        [0, -3, 7, 70], np.int32)), {}, TOL, "delay and sum")


def test_mimo_blocks_against_jax():
    rng = np.random.default_rng(6)
    rx, h = _cplx(rng, 3, 4, 256), _cplx(rng, 3, 4)
    for fn in ("mrc_combine", "egc_combine", "selection_combine"):
        check_parity(getattr(mimo, fn), getattr(ref_mimo, fn), (rx, h), {}, TOL, fn)
    g = np.asarray([1.0, 0.8, 0.4, 0.1, 0.05, 0.9], np.float32)
    check_parity(mimo.waterfilling, ref_mimo.waterfilling, (g, 3.0), {"noise_power": 0.5}, TOL)


def test_modcod_table_carries_across():
    ladder = convert.modcod_table_from_reference(ref_mimo.DEFAULT_MODCOD_TABLE)
    assert ladder == mimo.DEFAULT_MODCOD_TABLE
    got = mimo.AdaptiveModcod(ladder, up_margin_db=0.5)
    want = ref_mimo.AdaptiveModcod(up_margin_db=0.5)
    for snr in (1.0, 7.0, 13.2, 12.9, 20.0, 3.0):
        assert got.update(snr).name == want.update(snr).name


def test_blocks_tables_are_the_reference_tables():
    assert bf.BLOCKS == ref_bf.BLOCKS
