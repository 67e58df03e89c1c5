"""`ops.sensing` against the JAX package.

tests/test_sensing.py and the sensing cases of the known-answer files run
on the port through `torch_port_proxy`. Parity cases hold each function
against the reference on the same numpy inputs: decisions, indices and
counts equal, floats within TOL of the largest reference magnitude (FFTs
and sums in another order); CUMSUM_TOL where the port's cumulative sum
accumulates in float64 and rounds once while the reference's sums in
float32 (`acoustic_emission_count`'s energies, `sta_lta`, the order
tracker's shaft angle), so the card's sums equal the CPU's; LOOP_TOL for
the 200-step unmixing loop; SOLVE_TOL for the tidal fit's ill-conditioned
float32 normal equations. The traps have tests of their own: the order
tracker's three quirks on a track longer than `max_revs`, the cumulative
sums (and `seismic_pick`'s pick equal on the reference test's quake), the
clamped dynamic windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import sensing as ref
from r4w_tpu_torch.ops import sensing as sn
from torch_port_proxy import check_parity, compare, run_reference_test

TOL = 1e-5
CUMSUM_TOL = 1e-5   # float64-accumulated sums against the reference's float32 scan
LOOP_TOL = 1e-4     # 200 projected-gradient steps of float32 products
SOLVE_TOL = 1e-3    # float32 normal equations of a 9-column harmonic design

SN = "r4w_tpu_torch.ops.sensing"
SN_REF = {"r4w_tpu.ops.sensing": SN}

REFERENCE_TESTS = [
    *[("test_sensing", n, {}, {"sn": SN}) for n in (
        "TestAcoustic.test_ae_hit_counting", "TestAcoustic.test_gunshot_localization",
        "TestAcoustic.test_leak_locator_midpoint_and_offset",
        "TestAcoustic.test_avalanche_beacon_pulses",
        "TestAcoustic.test_drone_detector_finds_blade_rate",
        "TestVibration.test_order_tracking_flat_rpm", "TestVibration.test_wheel_flat",
        "TestVibration.test_wheel_flat_sub_resolution_period",
        "TestVibration.test_tip_timing_flags_wobbly_blade", "TestVibration.test_bearing_bands",
        "TestVibration.test_structural_shift_sign", "TestVibration.test_dam_seepage_score",
        "TestSeismic.test_sta_lta_pick", "TestSeismic.test_classifier_labels",
        "TestSpaceWeather.test_s4_index", "TestSpaceWeather.test_sigma_phi_detrends",
        "TestSpaceWeather.test_geomagnetic_index", "TestSpaceWeather.test_magnetic_anomaly",
        "TestSpaceWeather.test_gravity_gradients", "TestSpaceWeather.test_lightning_and_cosmic",
        "TestPhotonicNuclear.test_fbg_peak", "TestPhotonicNuclear.test_oct_a_scan_depth",
        "TestPhotonicNuclear.test_photoacoustic_focus", "TestPhotonicNuclear.test_mrs_quantify",
        "TestPhotonicNuclear.test_gamma_peaks", "TestPhotonicNuclear.test_bpm_position",
        "TestPhotonicNuclear.test_langmuir", "TestPhotonicNuclear.test_plasma_impedance",
        "TestEnvHealth.test_hyperspectral_unmixing", "TestEnvHealth.test_soil_moisture_monotone",
        "TestEnvHealth.test_spo2", "TestEnvHealth.test_tidal_fit_recovers_m2")],
    ("test_known_answers_r4j",
     "TestImpedanceTomography.test_centered_disc_reconstructs_centered_peak", SN_REF, {}),
    *[("test_known_answers_r4j", f"TestSeismicArrivalDetector.{n}", SN_REF, {}) for n in (
        "test_ratio_matches_numpy_rederivation", "test_pick_finds_onset_time",
        "test_no_event_returns_nan")],
    ("test_known_answers_r4m", "TestHyperspectralUnmix.test_noiseless_abundances_recovered",
     SN_REF, {}),
    ("test_known_answers_r4n", "TestSpo2.test_published_calibration_line", SN_REF, {}),
    ("test_known_answers_r4n", "TestTidalHarmonics.test_recovers_m2_s2_constituents", SN_REF, {}),
    *[("test_known_answers_r4s", n, SN_REF, {}) for n in (
        "TestScintillationIndices.test_s4_closed_forms",
        "TestScintillationIndices.test_sigma_phi_detrends_linear_ramp",
        "TestMagneticAnomaly.test_dipole_bump_detected_baseline_ignored",
        "TestGravityGradient.test_linear_field_gives_constant_gradients",
        "TestLightningStrokes.test_toa_polarity_rise_time",
        "TestCosmicRayCoincidence.test_counts_only_coincident_hits",
        "TestGeomagneticStorm.test_quiet_vs_disturbed",
        "TestFbgInterrogator.test_centroid_peak_wavelength",
        "TestOctAScan.test_fringe_frequency_maps_to_depth_bin",
        "TestMrsQuantify.test_two_metabolite_amplitude_ratio",
        "TestGammaSpectrum.test_photopeaks_at_known_energies",
        "TestBpmPosition.test_difference_over_sum",
        "TestOrderTracking.test_order2_line_under_rpm_ramp",
        "TestWheelFlat.test_impacts_at_rotation_period_detected",
        "TestTurbineTipTiming.test_vibrating_blade_stands_out")],
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    run_reference_test(monkeypatch, module, name, modules, **swaps)


@pytest.mark.parametrize("n", [64, 128, 256, 512])
def test_reference_hilbert_mask_on_port(monkeypatch, n):
    run_reference_test(monkeypatch, "test_known_answers_r4", "test_hilbert_analytic_magnitude",
                       SN_REF, params={"n": n})


def _quake(fs=100.0, n=6000, arrival=3000, seed=5):
    """tests/test_sensing.py's TestSeismic._quake."""
    rng = np.random.default_rng(seed)
    x = 0.05 * rng.standard_normal(n)
    t = np.arange(n - arrival) / fs
    x[arrival:] += np.exp(-t / 10.0) * np.sin(2 * np.pi * 2.0 * t) * 3.0
    return x


def _cases():
    r = np.random.default_rng(16)
    fs = 10e3
    ae = 0.01 * r.standard_normal(4096)
    ae[1000:1020] += 2.0
    ae[3000:3010] += 1.5
    ae[3100:3104] -= 1.2
    mics = np.stack([np.roll(r.standard_normal(1024), d) for d in (0, 7, -5, 12)]).astype(
        np.complex64)
    mic_pos = np.float32([[0, 0], [30, 0], [0, 30], [30, 30]])
    proj = np.maximum(0, 1 - np.linspace(-1.5, 1.5, 41) ** 2)[None].repeat(12, 0).astype(
        np.float32)
    beacon = (0.05 * r.standard_normal(20000) + 0j).astype(np.complex64)
    for k in range(0, 20000, 4000):
        beacon[k:k + 800] += 1.0
    audio = (np.sin(2 * np.pi * 150 * np.arange(8192) / 8e3) * (1 + 0.3 * np.sin(
        2 * np.pi * 300 * np.arange(8192) / 8e3)) + 0.1 * r.standard_normal(8192)).astype(
        np.float32)
    vib = (np.sin(2 * np.pi * 3 * np.arange(20000) / 1e3) + 0.1 * r.standard_normal(20000))
    rpm = np.full(20000, 600.0)
    wheel = 0.05 * r.standard_normal(8000)
    wheel[::400] += 3.0
    tips = np.sort(r.uniform(0, 1, 64)).astype(np.float32)
    bearing = (np.sin(2 * np.pi * 2000 * np.arange(16384) / 20e3) * (
        1 + 0.5 * (np.sin(2 * np.pi * 87 * np.arange(16384) / 20e3) > 0.9))
        + 0.05 * r.standard_normal(16384))
    power = r.gamma(4.0, 0.25, 1000).astype(np.float32)
    phase = np.cumsum(0.01 * r.standard_normal(1000)).astype(np.float32)
    field = (np.cumsum(r.standard_normal(3600)) + 30 * (np.arange(3600) > 2000)).astype(
        np.float32)
    mag = (np.linspace(0, 20, 2000) + r.standard_normal(2000) * 0.3).astype(np.float32)
    mag[1000:1010] += 12.0
    gz = np.add.outer(np.linspace(0, 1, 12), np.linspace(0, 2, 9)).astype(np.float32)
    efield = 0.1 * r.standard_normal(8000)
    efield[2000:2030] += np.linspace(3, 0, 30)
    efield[5000:5020] -= np.linspace(4, 0, 20)
    det_a = 0.1 * r.standard_normal(3000)
    det_b = 0.1 * r.standard_normal(3000)
    det_a[[100, 900, 2000]] += 5.0
    det_b[[102, 1500, 1999]] += 5.0
    spec = np.exp(-0.5 * ((np.arange(200) - 120.3) / 4.0) ** 2).astype(np.float32)
    wl = np.linspace(1540, 1560, 200).astype(np.float32)
    inter = np.cos(2 * np.pi * 37 * np.arange(1024) / 1024).astype(np.float32) + 1.0
    pa_data = r.standard_normal((8, 400)).astype(np.float32)
    pa_pos = np.stack([np.cos(np.arange(8)), np.sin(np.arange(8))], -1).astype(np.float32) * 0.02
    pa_px = np.stack(np.meshgrid(np.linspace(-0.01, 0.01, 6), np.linspace(-0.01, 0.01, 6)),
                     -1).reshape(-1, 2).astype(np.float32)
    fid_t = np.arange(2048) / 1000.0
    fid = (np.exp((2j * np.pi * 120 - 5) * fid_t) + 0.5 * np.exp((-2j * np.pi * 80 - 5) * fid_t)
           ).astype(np.complex64)
    heights = np.concatenate([r.normal(662, 15, 3000), r.normal(1332, 20, 2000),
                              r.uniform(0, 3000, 4000)]).astype(np.float32)
    bpm = [np.float32([1.2, 0.9]), np.float32([0.8, 1.1]), np.float32([0.7, 1.0]),
           np.float32([1.1, 0.95])]
    volts = np.linspace(-20, 10, 300).astype(np.float32)
    curr = (-0.1 + 2.0 * np.exp(np.minimum(volts, 5) / 3.0)).astype(np.float32)
    vw = np.sin(2 * np.pi * 5 * np.arange(512) / 512).astype(np.float32)
    iw = (0.5 * np.sin(2 * np.pi * 5 * np.arange(512) / 512 - 0.4)).astype(np.float32)
    endm = np.abs(r.standard_normal((3, 20))).astype(np.float32)
    abund = r.dirichlet(np.ones(3), 50).astype(np.float32)
    cube = (abund @ endm + 0.01 * r.standard_normal((50, 20))).astype(np.float32)
    hours = np.arange(0, 24 * 30, 0.5).astype(np.float32)
    tide = (1.2 * np.cos(2 * np.pi * hours / 12.42 - 0.3) + 0.4 * np.cos(
        2 * np.pi * hours / 12.0 + 1.0) + 0.1 * r.standard_normal(hours.size)).astype(np.float32)
    return [
        ("acoustic_emission_count", sn.acoustic_emission_count, ref.acoustic_emission_count,
         (ae,), CUMSUM_TOL),
        ("gunshot_localize", lambda m, p: sn.gunshot_localize(list(m), p, 48e3),
         lambda m, p: ref.gunshot_localize(list(m), p, 48e3), (mics, mic_pos), 1e-4),
        ("impedance_tomography", lambda m: sn.impedance_tomography_backproject(
            m, np.linspace(0, 165, 12), 24), lambda m: ref.impedance_tomography_backproject(
            m, np.linspace(0, 165, 12), 24), (proj,), TOL),
        ("leak_locate", lambda a, b: sn.leak_locate(a, b, 100.0, fs),
         lambda a, b: ref.leak_locate(a, b, 100.0, fs), (mics[0], mics[1]), TOL),
        ("avalanche_beacon_search", lambda x: sn.avalanche_beacon_search(x, 10e3, frame_s=0.01),
         lambda x: ref.avalanche_beacon_search(x, 10e3, frame_s=0.01), (beacon,), TOL),
        ("drone_acoustic_detect", lambda a: sn.drone_acoustic_detect(a, 8e3),
         lambda a: ref.drone_acoustic_detect(a, 8e3), (audio,), TOL),
        ("envelope_order_spectrum", lambda v, p: sn.envelope_order_spectrum(v, 1e3, p, 6, 64),
         lambda v, p: ref.envelope_order_spectrum(v, 1e3, p, 6, 64), (vib, rpm), CUMSUM_TOL),
        ("wheel_flat_detect", lambda v: sn.wheel_flat_detect(v, 1e3, 2.0, 5.0),
         lambda v: ref.wheel_flat_detect(v, 1e3, 2.0, 5.0), (wheel,), TOL),
        ("turbine_tip_timing", lambda t: sn.turbine_tip_timing(t, 3600.0, 8),
         lambda t: ref.turbine_tip_timing(t, 3600.0, 8), (tips,), TOL),
        ("bearing_health_bands", lambda v: [sn.bearing_health_bands(v, 20e3, 87.0, 140.0)[k]
                                            for k in ("bpfo", "bpfi")],
         lambda v: [ref.bearing_health_bands(v, 20e3, 87.0, 140.0)[k] for k in ("bpfo", "bpfi")],
         (bearing,), TOL),
        ("structural_modal_shift", lambda a, b: sn.structural_modal_shift(a, b, 20e3),
         lambda a, b: ref.structural_modal_shift(a, b, 20e3), (bearing, bearing[::-1]), TOL),
        ("dam_seepage_score", lambda x: sn.dam_seepage_score(x, 20e3),
         lambda x: ref.dam_seepage_score(x, 20e3), (bearing,), TOL),
        ("sta_lta", lambda x: sn.sta_lta(x, 50, 500), lambda x: ref.sta_lta(x, 50, 500),
         (_quake(),), CUMSUM_TOL),
        ("seismic_pick", lambda x: sn.seismic_pick(x, 100.0), lambda x: ref.seismic_pick(x, 100.0),
         (_quake(),), 0.0),
        ("scintillation", lambda p, ph: (sn.scintillation_s4(p), sn.scintillation_sigma_phi(ph)),
         lambda p, ph: (ref.scintillation_s4(p), ref.scintillation_sigma_phi(ph)), (power, phase),
         TOL),
        ("geomagnetic_storm_index", lambda b: sn.geomagnetic_storm_index(b, 1.0, 60.0),
         lambda b: ref.geomagnetic_storm_index(b, 1.0, 60.0), (field,), TOL),
        ("magnetic_anomaly_detect", lambda b: sn.magnetic_anomaly_detect(b, 64, 3.0),
         lambda b: ref.magnetic_anomaly_detect(b, 64, 3.0), (mag,), TOL),
        ("gravity_gradient_tensor", lambda g: sn.gravity_gradient_tensor(g, 5.0),
         lambda g: ref.gravity_gradient_tensor(g, 5.0), (gz,), TOL),
        ("lightning_stroke_analyze", lambda e: sn.lightning_stroke_analyze(e, 1e5, 6.0, 8),
         lambda e: ref.lightning_stroke_analyze(e, 1e5, 6.0, 8), (efield,), TOL),
        ("cosmic_ray_coincidence", sn.cosmic_ray_coincidence, ref.cosmic_ray_coincidence,
         (det_a, det_b), 0.0),
        ("fbg_wavelength_shift", sn.fbg_wavelength_shift, ref.fbg_wavelength_shift, (spec, wl),
         TOL),
        ("oct_a_scan", sn.oct_a_scan, ref.oct_a_scan, (inter,), TOL),
        ("photoacoustic_reconstruct", lambda d, p, q: sn.photoacoustic_reconstruct(d, p, q),
         lambda d, p, q: ref.photoacoustic_reconstruct(d, p, q), (pa_data, pa_pos, pa_px), TOL),
        ("mrs_quantify", lambda x: sn.mrs_quantify(x, 1000.0, [120.0, -80.0, 499.0]),
         lambda x: ref.mrs_quantify(x, 1000.0, [120.0, -80.0, 499.0]), (fid,), TOL),
        ("gamma_spectrum", sn.gamma_spectrum, ref.gamma_spectrum, (heights,), TOL),
        ("bpm_position", lambda a, b, c, d: sn.bpm_position([a, b, c, d]),
         lambda a, b, c, d: ref.bpm_position([a, b, c, d]), tuple(bpm), TOL),
        ("langmuir_analyze", lambda v, i: [sn.langmuir_analyze(v, i)[k]
                                           for k in ("v_float", "te_ev")],
         lambda v, i: [ref.langmuir_analyze(v, i)[k] for k in ("v_float", "te_ev")],
         (volts, curr), TOL),
        ("plasma_impedance", sn.plasma_impedance, ref.plasma_impedance, (vw, iw), TOL),
        ("hyperspectral_unmix", sn.hyperspectral_unmix, ref.hyperspectral_unmix, (cube, endm),
         LOOP_TOL),
        ("soil_spo2", lambda g, a: (sn.soil_moisture_permittivity(g), sn.spo2_ratio(
            a, 2.0, a * 1.3, 2.5)), lambda g, a: (ref.soil_moisture_permittivity(g), ref.spo2_ratio(
                a, 2.0, a * 1.3, 2.5)), (np.linspace(0.05, 0.9, 30).astype(np.float32),
                                         np.linspace(0.01, 0.05, 9).astype(np.float32)), TOL),
        ("tidal_harmonic_fit", sn.tidal_harmonic_fit, ref.tidal_harmonic_fit, (tide, hours),
         SOLVE_TOL),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,port,want,args,tol", CASES, ids=[c[0] for c in CASES])
def test_parity(name, port, want, args, tol):
    check_parity(port, want, args, tol=tol, label=name)


def test_order_spectrum_quirks_on_a_long_track():
    """A track of 800 revolutions into a grid of max_revs = 64: the grid keeps
    the first 64 revolutions only, the Hann window's length counts all 800
    (so within the grid it is the rising first twelfth of a window), and
    the spectrum is divided by that count: the port reproduces all three
    (against the reference within CUMSUM_TOL) and a numpy model of them."""
    fs, max_revs = 1e3, 64
    rpm = np.full(80_000, 600.0, np.float32)          # 10 rev/s for 80 s
    t = np.arange(rpm.size) / fs
    vib = np.sin(2 * np.pi * 3 * 10 * t).astype(np.float32)   # order 3
    got = sn.envelope_order_spectrum(torch.from_numpy(vib), fs, torch.from_numpy(rpm), 6,
                                     max_revs)
    compare(got, ref.envelope_order_spectrum(jnp.asarray(vib), fs, jnp.asarray(rpm), 6, max_revs),
            CUMSUM_TOL)
    revs = np.cumsum(rpm.astype(np.float64) / 60.0) / fs
    n_valid = np.floor(revs[-1]) * 64
    assert n_valid == 800 * 64 > max_revs * 64
    i = np.arange(max_revs * 64)
    resampled = np.interp(i / 64.0, revs, vib)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * i / n_valid)
    model = np.abs(np.fft.rfft(resampled * win))[np.arange(1, 7) * max_revs] / n_valid
    compare(got, model, 1e-3)


def test_cumulative_sums_are_card_independent():
    """The cumulative sums accumulate in float64 and round once, equal to a
    numpy float64 cumsum rounded to float32 (what the card computes too);
    `seismic_pick` picks the reference's sample on tests/test_sensing.py's
    quake, and the STA/LTA ratio stays within CUMSUM_TOL of the reference's
    float32 scan."""
    x = _quake()
    a = np.abs(x.astype(np.float32))
    c = np.concatenate([[0.0], np.cumsum(a.astype(np.float64))]).astype(np.float32)
    sta = (c[50:] - c[:-50]) / np.float32(50)
    lta = (c[500:] - c[:-500]) / np.float32(500)
    m = min(sta.size, lta.size)
    want = sta[-m:] / np.maximum(lta[-m:], np.float32(1e-12))
    np.testing.assert_array_equal(sn.sta_lta(torch.from_numpy(x), 50, 500).numpy(), want)
    assert float(sn.seismic_pick(torch.from_numpy(x), 100.0)) == float(
        ref.seismic_pick(jnp.asarray(x), 100.0))
    ae = np.zeros(512, np.float32)
    ae[100:140] = 1.7
    n, starts, energies, valid = sn.acoustic_emission_count(torch.from_numpy(ae))
    csum = np.concatenate([[0.0], np.cumsum((ae * ae).astype(np.float64))]).astype(np.float32)
    assert int(n) == 1 and int(starts[0]) == 100 and bool(valid[0])
    assert float(energies[0]) == float(csum[140] - csum[100])   # the run ends at sample 140


@pytest.mark.parametrize("peak", [1, 198])
def test_dynamic_windows_clamp_their_start(peak):
    """A peak within 3 samples of either end: the 7-sample window starts at
    0 or n − 7, as ``lax.dynamic_slice`` clamps it."""
    s = np.zeros(200, np.float32)
    s[peak] = 1.0
    s[peak - 1] = 0.5
    wl = np.linspace(1540, 1560, 200).astype(np.float32)
    compare(sn.fbg_wavelength_shift(torch.from_numpy(s), torch.from_numpy(wl)),
            ref.fbg_wavelength_shift(jnp.asarray(s), jnp.asarray(wl)), TOL)
    fid = np.exp(2j * np.pi * 0.49 * np.arange(256)).astype(np.complex64)
    compare(sn.mrs_quantify(torch.from_numpy(fid), 1.0, [0.49, -0.5]),
            ref.mrs_quantify(jnp.asarray(fid), 1.0, [0.49, -0.5]), TOL)


def test_linspace_is_the_reference_compiled_form():
    """The grids of the tomography and the histogram edges: `hostio.linspace`
    computes the reference's compiled ``jnp.linspace`` (its one fused
    multiply-add by `hostio.fma`, exact), equal at all but a handful of
    points of these grids, and at every point where the stop is a tensor
    from [0, stop] (`adaptive.am_am_curve`'s edges); `fma` rounds once,
    where a float64 sum rounded again to float32 would not."""
    from r4w_tpu_torch.core.hostio import fma, linspace

    r = np.random.default_rng(1)
    grids = [(-1.0, 1.0, 24), (-1.0, 1.0, 64), (0.0, 3000.0, 257), (-50.0, 50.0, 16)]
    grids += [(float(a), float(a + b), int(n)) for a, b, n in zip(
        r.uniform(-100, 100, 8), r.uniform(0.1, 500, 8), r.integers(2, 300, 8))]
    differ = sum(int(np.sum(linspace(a, b, n, "cpu").numpy() != np.asarray(jnp.linspace(a, b, n))))
                 for a, b, n in grids)
    assert differ <= 2
    for stop, n in zip(r.uniform(0.01, 5.0, 16).astype(np.float32), r.integers(2, 200, 16)):
        np.testing.assert_array_equal(linspace(0.0, torch.tensor(stop), int(n)).numpy(),
                                      np.asarray(jnp.linspace(0.0, jnp.float32(stop), int(n))))
    a = np.float32([1.0 + 2.0 ** -12])
    b = np.float32([1.0 + 2.0 ** -12])
    c = np.float32([-1.0 - 2.0 ** -11])
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    assert float(got[0]) == 2.0 ** -24    # a·b + c exactly, not 0
    x = r.standard_normal((3, 1000)).astype(np.float32)
    exact = (x[0].astype(np.float64) * x[1] + x[2]).astype(np.float32)
    np.testing.assert_array_equal(fma(*map(torch.from_numpy, x)).numpy(), exact)


def test_seismic_classify_is_the_reference_numpy():
    r = np.random.default_rng(6)
    for x in (_quake(), 0.05 * r.standard_normal(6000)):
        assert sn.seismic_classify(torch.from_numpy(x), 100.0) == ref.seismic_classify(x, 100.0)
