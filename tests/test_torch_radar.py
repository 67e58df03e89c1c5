"""`ops.radar`, `ops.radar_sonar`, `ops.radar_adv` and `ops.ew` against the
JAX package.

The reference's own test functions (tests/test_radar_sonar.py,
test_radar_adv.py, test_ew_ops.py, the radar parts of test_ops_gaps.py and
of the known-answer files) run on the port through `torch_port_proxy`.
Parity tests hold the port against the reference on the same numpy inputs:
decisions (masks, indices, counts) equal, floats within TOL of the
largest reference magnitude (FFTs, sums and float32 products in another
order), LOOSE_TOL where a solve stands between (MVDR), SOLVE_TOL for STAP's
ill-conditioned covariance. `check_parity` covers what those tests do not:
the functions the radar gate composes, the port's batch axes, and each
trap of the slice: the clamped ``csum[starts]`` gather, the stable argsort, the
float32 root that moves an SAS index, and ``cfar_2d`` with a strong target
in the guard cells.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import ew as ref_ew
from r4w_tpu.ops import radar as ref_radar
from r4w_tpu.ops import radar_adv as ref_ra
from r4w_tpu.ops import radar_sonar as ref_rs
from r4w_tpu_torch import convert
from r4w_tpu_torch.ops import ew, radar, radar_adv as ra, radar_sonar as rs
from torch_port_proxy import check_parity, compare, run_reference_test

TOL = 1e-5
LOOSE_TOL = 1e-4
SOLVE_TOL = 1e-3

RS, RA, EW, RADAR = ("r4w_tpu_torch.ops.radar_sonar", "r4w_tpu_torch.ops.radar_adv",
                     "r4w_tpu_torch.ops.ew", "r4w_tpu_torch.ops.radar")

REFERENCE_TESTS = [
    *[("test_radar_sonar", n, {}, {"rs": RS}) for n in (
        "TestPulseDoppler.test_pd_map_peak_location", "TestPulseDoppler.test_rd_detector_flags_target",
        "TestPulseDoppler.test_range_migration_straightens",
        "TestPulseDoppler.test_doppler_estimators", "TestPulseDoppler.test_doppler_pre_correct",
        "TestBistaticIsar.test_bistatic_map_peak_at_delay", "TestBistaticIsar.test_isar_is_pd_map",
        "TestSonar.test_sonar_tvg_and_range_axis", "TestSonar.test_bottom_profiler",
        "TestSonar.test_sas_focuses_point_target", "TestDisplayClassify.test_ppi_maps_north",
        "TestDisplayClassify.test_waveform_classifier", "TestDisplayClassify.test_pdw_extraction",
        "TestAutomotiveLidar.test_fmcw_automotive_angle",
        "TestAutomotiveLidar.test_lidar_peaks_and_cloud",
        "TestGprOtdrNdt.test_gpr_background_removal", "TestGprOtdrNdt.test_otdr_events",
        "TestGprOtdrNdt.test_ndt_thickness", "TestWeather.test_rcs_estimate_inverts_radar_equation",
        "TestWeather.test_clutter_suppression_keeps_weather")],
    *[("test_radar_adv", n, {}, {"ra": RA}) for n in (
        "TestStap.test_stap_nulls_clutter_keeps_target", "TestStap.test_stap_beats_nonadaptive_sinr",
        "TestClutterIntegration.test_clutter_notch_removes_static_keeps_mover",
        "TestClutterIntegration.test_coherent_gain",
        "TestTracker.test_tracks_constant_velocity_target",
        "TestTracker.test_two_targets_and_dropout")],
    *[("test_ew_ops", n, {}, {"ew": EW}) for n in (
        "test_esprit_doa_two_sources", "test_esprit_frequencies", "test_sar_point_target_focuses",
        "test_cross_ambiguity_finds_delay_doppler", "test_cancel_dsi_suppresses_direct_path",
        "test_gcc_phat_delay", "test_tdoa_localize", "test_pulse_characterizer",
        "test_esm_scan_two_emitters")],
    ("test_ops_gaps", "TestEqRadarResample.test_sar_compress_focuses_point_target", {},
     {"ew": EW}),
    *[("test_ops_gaps", f"TestEqRadarResample.{n}", {}, {"radar": RADAR}) for n in (
        "test_cfar_2d_detects_target", "test_beamformer_gain",
        "test_ambiguity_function_peak_at_origin")],
    *[("test_known_answers_r4d", n, {"r4w_tpu.ops.radar": RADAR}, {}) for n in (
        "TestCfarCalibration.test_alpha_matches_published_formula",
        "TestCfarCalibration.test_empirical_false_alarm_rate_on_exponential_noise",
        "TestCfarCalibration.test_cfar_2d_hits_target_and_stays_quiet",
        "TestLfmCompression.test_compression_peak_at_zero_lag_with_bt_gain",
        "TestLfmCompression.test_sidelobe_level_near_13_2_db",
        "TestLfmCompression.test_ambiguity_range_doppler_coupling",
        "TestArrayClosedForms.test_music_recovers_two_sources_exactly_on_grid",
        "TestArrayClosedForms.test_mvdr_distortionless_constraint_exact",
        "TestArrayClosedForms.test_mvdr_nulls_strong_interferer",
        "TestArrayClosedForms.test_ula_conventional_beam_null_positions")],
    *[("test_known_answers_r4j", n, {"r4w_tpu.ops.radar_sonar": RS}, {}) for n in (
        "TestMatchedFilterPulseRadar.test_peak_at_delay_with_replica_energy",
        "TestMatchedFilterPulseRadar.test_matches_numpy_fft_correlation",
        "TestRangeVelocityDecoupling.test_recovers_range_and_velocity_beats")],
    ("test_known_answers_r4l", "TestMtiAndIntegration.test_mti_binomial_response",
     {"r4w_tpu.ops.radar": RADAR}, {}),
    *[("test_known_answers_r4l", n, {"r4w_tpu.ops.radar_adv": RA}, {}) for n in (
        "TestMtiAndIntegration.test_clutter_notch_preserves_moving_target",
        "TestMtiAndIntegration.test_integration_gain_laws")],
    ("test_known_answers_r4n", "TestRangeDopplerMap.test_target_lands_on_exact_cell",
     {"r4w_tpu.ops.radar": RADAR}, {}),
    *[("test_known_answers_r4q", n, {"r4w_tpu.ops.radar_sonar": RS}, {}) for n in (
        "TestFmcwAutomotive.test_beat_bins_place_range_and_doppler",
        "TestPulseDescriptors.test_toa_width_amplitude_frequency")],
    ("test_known_answers_r4r", "TestRadarTracker.test_cv_target_confirmed_and_velocity_estimated",
     {"r4w_tpu.ops.radar_adv": RA}, {}),
    ("test_known_answers_r4r", "TestLidarPeakMatch.test_two_returns_at_exact_offsets",
     {"r4w_tpu.ops.radar_sonar": RS}, {}),
    ("test_known_answers_r4r", "TestStapWeights.test_distortionless_constraint_and_interferer_null",
     {"r4w_tpu.ops.radar_adv": RA}, {}),
    *[("test_known_answers_r4t", n, {"r4w_tpu.ops.radar_sonar": RS}, {}) for n in (
        "TestBottomProfile.test_two_way_depth_law", "TestNdtThickness.test_backwall_echo_spacing",
        "TestOtdrAnalyze.test_slope_and_event_classification",
        "TestPulsePairDoppler.test_parametric_and_gated_estimators",
        "TestWeatherClutterSuppress.test_dc_notch_keeps_weather",
        "TestRcsEstimate.test_radar_equation_inverse")],
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    run_reference_test(monkeypatch, module, name, modules, **swaps)


def _cplx(rng, *shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _chirp(n, k=0.5):
    t = np.arange(n) / n
    return np.exp(1j * np.pi * k * n * t * t).astype(np.complex64)


def _pd_cube(rng, n_pulses=32, n_range=128, tgt=40, dop=0.2):
    rep = _chirp(16)
    cube = 0.01 * _cplx(rng, n_pulses, n_range)
    for p in range(n_pulses):
        cube[p, tgt:tgt + 16] += rep * np.exp(2j * np.pi * dop * p)
    return cube.astype(np.complex64), rep


R = np.random.default_rng(15)
CUBE, REP = _pd_cube(R)
LISTEN = (np.exp(1j * np.pi * np.outer(np.arange(8), np.sin(np.deg2rad([40.0]))))
          @ (10 * _cplx(R, 1, 300)) + _cplx(R, 8, 300)).astype(np.complex64)
PULSES = np.zeros(4096, np.complex64)
PULSES[500:700] = np.exp(2j * np.pi * 0.05 * np.arange(200))
PULSES[2000:2100] = 0.5 * np.exp(-2j * np.pi * 0.03 * np.arange(100))
FS = 1e6

def test_mvdr_stacked_looks_equal_one_look_at_a_time():
    looks = [-30.0, 22.5]
    w = radar.mvdr_weights(torch.from_numpy(LISTEN), looks)
    assert w.shape == (2, 8)
    for i, look in enumerate(looks):
        compare(w[i], ref_radar.mvdr_weights(jnp.asarray(LISTEN), look), LOOSE_TOL, str(look))


def test_beamform_batches_beams_and_leading_axes():
    w = _cplx(R, 5, 8)
    x = _cplx(R, 8, 3, 40)
    got = radar.beamform(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (5, 3, 40)
    for b in range(5):
        for p in range(3):
            compare(got[b, p], ref_radar.beamform(jnp.asarray(x[:, p]), jnp.asarray(w[b])), TOL)


def test_cfar_2d_strong_target_in_guard_cells():
    """A target 60 dB over the noise two cells from a weak one, inside the
    weak cell's guard ring: the ring's sum never sees the strong cell, and a
    box-minus-inner sum would lose the weak cell's noise digits to it. The
    masks equal JAX's, and the thresholds agree."""
    rng = np.random.default_rng(7)
    p = rng.exponential(1.0, (48, 64)).astype(np.float32)
    p[20, 30] = 1e6
    p[21, 31] = 30.0
    got = radar.cfar_2d(torch.from_numpy(p), guard=1, train=4, pfa=1e-4)
    want = ref_radar.cfar_2d(jnp.asarray(p), guard=1, train=4, pfa=1e-4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0][21, 31] and got[0][20, 30]
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=TOL)


def test_cfar_2d_batches_leading_axes():
    p = np.random.default_rng(8).exponential(1.0, (3, 40, 50)).astype(np.float32)
    got_mask, got_thr = radar.cfar_2d(torch.from_numpy(p), 2, 8, 1e-6)
    for i in range(3):
        want_mask, want_thr = ref_radar.cfar_2d(jnp.asarray(p[i]), 2, 8, 1e-6)
        np.testing.assert_array_equal(got_mask[i].numpy(), np.asarray(want_mask))
        np.testing.assert_allclose(got_thr[i].numpy(), np.asarray(want_thr), rtol=TOL)


SCAN = np.zeros((360, 64), np.float32)
SCAN[90, 32], SCAN[200, 10], SCAN[359, 63] = 1.0, 2.0, 3.0

SONAR_CASES = [  # the functions the radar gate composes, and the PPI's truncated indices
    ("matched_filter_pulses", (CUBE, REP), {}, TOL),
    ("range_doppler_detect", (CUBE, REP), {}, TOL),
    ("radar_display_ppi", (SCAN, 101), {}, TOL),
]


@pytest.mark.parametrize("name,args,kwargs,tol", SONAR_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SONAR_CASES)])
def test_radar_sonar_against_jax(name, args, kwargs, tol):
    check_parity(getattr(rs, name), getattr(ref_rs, name), args, kwargs, tol, name)


def test_sas_image_against_jax():
    rep = _chirp(32)
    positions = np.linspace(-2.0, 2.0, 16)
    pings = np.zeros((16, 4096), np.complex64)
    for i, px in enumerate(positions):
        k = int(2 * np.sqrt((0.3 - px) ** 2 + 12.0 ** 2) / 1500.0 * 100e3)
        pings[i, k:k + 32] += rep
    args = (pings, rep, positions, np.linspace(-1.0, 1.0, 21), np.linspace(11.0, 13.0, 21))
    check_parity(rs.sas_image, ref_rs.sas_image, args, {}, TOL, "sas_image")


def test_float32_root_that_moves_an_sas_index():
    """√(dx² + r²) for dx = 1.2960384, r = 11.763822 is 11.835000038 when
    correctly rounded, as the reference's root is, and 11.835 exactly from
    torch's float32 sqrt on the CPU: 2·r/c·fs truncates to bin 1578 or
    1577. The port roots in float64 and rounds once, so its pixel reads the
    reference's bin."""
    dx, r = np.float32(1.2960383892059326), np.float32(11.763821601867676)
    v = torch.tensor([dx * dx + r * r])
    careless = int((2.0 * torch.sqrt(v) / torch.tensor(1500.0) * 100e3).to(torch.int32))
    assert careless == 1577                            # what a careless root picks
    pings = np.zeros((1, 4096), np.complex64)
    pings[0, 1578] = 1.0                               # a replica of [1] compresses nothing
    args = (pings, np.ones(1, np.complex64), np.zeros(1), np.asarray([dx]), np.asarray([r]))
    got = rs.sas_image(*[torch.from_numpy(np.asarray(a)) for a in args])
    want = ref_rs.sas_image(*[jnp.asarray(a) for a in args])
    assert float(want[0, 0]) > 0.99 and float(got[0, 0]) > 0.99   # bin 1578 read, not 1577


def test_pulse_descriptors_clamp_the_unused_slots_gather():
    """Two pulses in 32 slots: the 30 unused slots start at n, one past the
    cumulative sum's end. JAX's gather clamps that index; the port clamps
    it explicitly (an unclamped torch gather raises), and the masked slots
    read zero on both sides."""
    got = rs.pulse_descriptors(torch.from_numpy(PULSES), FS)
    want = ref_rs.pulse_descriptors(jnp.asarray(PULSES), FS)
    compare(got, want, TOL)
    assert int(got[4].sum()) == 2
    with pytest.raises(IndexError):
        torch.zeros(PULSES.shape[0])[torch.full((2,), PULSES.shape[0])]


def test_lidar_peak_match_sorts_stably():
    """min_sep 1 and 0 on a flat-topped return: picks that are equal
    neighbours (or the same bin again), and invalid slots; the stable argsort keeps the
    reference's order of equal keys (the invalid slots' inf), and every row
    equals JAX's."""
    w = np.zeros(256, np.float32)
    w[100:104] = 1.0
    t = np.ones(1, np.float32)
    for max_returns, min_sep in ((5, 1), (4, 0)):
        check_parity(rs.lidar_peak_match, ref_rs.lidar_peak_match, (w, t),
                     {"max_returns": max_returns, "min_sep": min_sep}, 0.0, str(min_sep))


def test_stap_against_jax():
    """The STAP solve of a 32 × 32 sample covariance whose clutter ridge
    sits 23 dB over the noise: within SOLVE_TOL."""
    rng = np.random.default_rng(16)
    snaps = (np.sqrt(0.005) * _cplx(rng, 120, 32)).astype(np.complex64)
    for i in range(120):
        for fs in rng.uniform(-0.5, 0.5, 6):
            snaps[i] += complex(rng.standard_normal(), rng.standard_normal()) * np.asarray(
                ra.space_time_steering(4, 8, fs, fs, device="cpu"))
    v = ra.space_time_steering(4, 8, 0.1, -0.35, device="cpu").numpy()
    check_parity(ra.stap_weights, ref_ra.stap_weights, (snaps, v), {}, SOLVE_TOL, "stap")


def test_radar_tracker_against_jax():
    """Two crossing targets and clutter over 12 scans: the same tracks,
    states within float32 rounding."""
    rng = np.random.default_rng(17)
    got, want = ra.RadarTracker(0.1, gate=15.0, device="cpu"), ref_ra.RadarTracker(0.1, gate=15.0)
    for k in range(12):
        dets = [500.0 + 5.0 * k + rng.normal(0, 1.0), 520.0 - 4.0 * k + rng.normal(0, 1.0),
                rng.uniform(0, 1000)]
        g, w = got.step(dets), want.step(dets)
        assert [t.track_id for t in g] == [t.track_id for t in w]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.x, np.asarray(b.x), rtol=TOL, atol=1e-4)
    carried = [convert.radar_track_from_reference(t) for t in want.tracks]
    assert [(t.track_id, t.hits, t.misses) for t in carried] == \
        [(t.track_id, t.hits, t.misses) for t in got.tracks]
    for a, b in zip(carried, got.tracks):
        np.testing.assert_allclose(a.cov, b.cov, rtol=1e-4, atol=1e-4)


def test_gcc_phat_window_clamp():
    """The window of 2·max_delay + 1 lags starts where ``lax.dynamic_slice``
    starts it: at the largest max_delay that fits (an odd-length
    correlation, max_delay = n // 2) the start is 0, and a window longer
    than the correlation raises on both sides."""
    rng = np.random.default_rng(19)
    a, b = _cplx(rng, 33), _cplx(rng, 32)
    check_parity(ew.gcc_phat, ref_ew.gcc_phat, (a, b), {"max_delay": 32}, TOL, "edge")
    with pytest.raises(ValueError):
        ew.gcc_phat(torch.from_numpy(a), torch.from_numpy(b), max_delay=33)
    with pytest.raises(TypeError):
        ref_ew.gcc_phat(jnp.asarray(a), jnp.asarray(b), max_delay=33)


def test_blocks_tables_are_the_reference_tables():
    assert rs.BLOCKS == ref_rs.BLOCKS
