"""`core.linalg` and `ops.propagation` against the JAX package, and the
static 2-ray case of `entry.fading_gate`.

The reference's own test functions (the link-budget, satellite, weather and
sounding tests of tests/test_cognitive_propagation.py, the propagation
known answers of test_known_answers_r4c.py and r4p) run on the port through
`torch_port_proxy`. `check_parity` covers the rest, floats within TOL of
the largest reference magnitude (LSTSQ_TOL for the normal equations'
solve, ORBIT_TOL for float32 Kepler iterations whose sines and cosines
differ by an ulp between the libraries at 7,000 km), decisions equal. The
traps: ``tle_propagate`` computes its times in float32, as the reference
does with 64-bit types off; ``multipath_profile`` keeps the strongest taps
by a stable sort, so equal magnitudes keep the lower delay, as
``lax.top_k`` does. The 2-ray case runs the reference's test on its own
draws, in JAX and in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.channel import awgn as ref_awgn, multipath_2ray as ref_2ray
from r4w_tpu.core import linalg as ref_linalg
from r4w_tpu.ops import propagation as ref_pr
from r4w_tpu.waveforms import create_waveform as ref_create_waveform
from r4w_tpu_torch import convert, entry
from r4w_tpu_torch.core import linalg
from r4w_tpu_torch.ops import propagation as pr
from torch_port_proxy import check_parity, compare, run_reference_test

TOL = 1e-5
LSTSQ_TOL = 1e-4
ORBIT_TOL = 1e-5

PR = "r4w_tpu_torch.ops.propagation"

REFERENCE_TESTS = [
    *[("test_cognitive_propagation", n, {}, {"pr": PR}) for n in (
        "TestLinkBudget.test_budget_matches_hand_calc", "TestLinkBudget.test_optimizer_closes_the_loop",
        "TestSatellite.test_tle_parse_and_orbit_radius",
        "TestSatellite.test_pass_prediction_finds_windows",
        "TestWeatherProp.test_rain_attenuation_increases_with_rate_and_freq",
        "TestWeatherProp.test_propagation_models_ordering",
        "TestWeatherProp.test_fso_margin_degrades_in_fog", "TestSounding.test_freq_sound_and_profile",
        "TestSounding.test_sparse_equalizer_flattens", "TestSounding.test_ls_channel_estimate",
        "TestSounding.test_dynamic_channel_switches", "TestSounding.test_mode_sounder_finds_layers")],
    *[("test_known_answers_r4c", n, {}, {"P": PR}) for n in (
        "test_fspl_known_value_2g4_1km", "test_link_budget_noise_floor_is_ktb",
        "test_link_budget_optimize_closes_the_loop", "test_troposcatter_loss_scaling_laws",
        "test_fso_margin_decreases_with_range_and_fog", "test_hata_urban_against_published_example",
        "test_tle_propagate_radius_matches_keplers_third_law",
        "test_tle_propagate_period_and_inclination", "test_pass_predict_finds_overhead_window",
        "test_ls_channel_estimate_recovers_known_fir",
        "test_freq_domain_sound_flat_for_identity_channel",
        "test_sparse_multipath_equalize_restores_qpsk", "test_dynamic_channel_markov_occupancy",
        "test_rain_attenuation_power_law_shape")],
    ("test_known_answers_r4p", "TestMultipathProfile.test_two_tap_delays_and_gains",
     {"r4w_tpu.ops.propagation": PR}, {}),
]


@pytest.mark.parametrize("module,name,modules,swaps", REFERENCE_TESTS,
                         ids=[f"{t[0]}::{t[1]}" for t in REFERENCE_TESTS])
def test_reference_test_on_port(monkeypatch, module, name, modules, swaps):
    run_reference_test(monkeypatch, module, name, modules, **swaps)


def _cplx(rng, *shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(
        np.complex64)


L1 = "1 25544U 98067A   26047.50000000  .00016717  00000-0  10270-3 0  9000"
L2 = "2 25544  51.6400 208.9163 0006317  69.9862 290.2000 15.54225995 10000"


def test_complex_lstsq_against_jax():
    rng = np.random.default_rng(1)
    a, b = _cplx(rng, 80, 6), _cplx(rng, 80)
    check_parity(linalg.complex_lstsq, ref_linalg.complex_lstsq, (a, b), {}, LSTSQ_TOL, "lstsq")
    got = linalg.complex_lstsq(torch.from_numpy(np.stack([a, 2 * a])),
                               torch.from_numpy(np.stack([b, b])))
    compare(got[1], ref_linalg.complex_lstsq(jnp.asarray(2 * a), jnp.asarray(b)), LSTSQ_TOL)


def test_tle_propagate_in_float32_days_after_epoch():
    """Three days and a second after epoch a float32 time carries 0.03 s of
    rounding and the mean anomaly n·t ~ 300 rad an ulp of 3e-5 rad: both
    packages compute that float32 orbit (within ORBIT_TOL of each other),
    which lies hundreds of metres off the float64 one."""
    tle = convert.tle_from_reference(ref_pr.Tle.parse(L1, L2))
    assert tle == pr.Tle.parse(L1, L2)
    t = np.asarray([259_201.0, 259_201.37, 259_260.0])
    got = pr.tle_propagate(tle, torch.from_numpy(t))
    assert got.dtype == torch.float32
    compare(got, ref_pr.tle_propagate(ref_pr.Tle.parse(L1, L2), jnp.asarray(t)), ORBIT_TOL)
    n_rad = tle.mean_motion_rev_day * 2 * np.pi / 86400.0
    m64 = np.deg2rad(tle.mean_anomaly_deg) + n_rad * t
    m32 = np.float32(np.deg2rad(tle.mean_anomaly_deg)) + np.float32(n_rad) * t.astype(np.float32)
    assert np.max(np.abs(m64 - m32)) * 6.79e6 > 100.0   # metres along the orbit


def test_pass_predict_against_jax():
    tle = pr.Tle.parse(L1, L2)
    lon = np.deg2rad(28.9)
    site = 6371e3 * np.array([np.cos(lon), np.sin(lon), 0.0])
    t = np.arange(0, 3 * 5400, 30.0)
    check_parity(lambda s, tt: pr.pass_predict(tle, s, tt, 0.0),
                 lambda s, tt: ref_pr.pass_predict(ref_pr.Tle.parse(L1, L2), s, tt, 0.0),
                 (site, t), {}, ORBIT_TOL, "pass_predict")


def test_multipath_profile_ties_keep_the_lower_delay():
    """Four taps of exactly equal magnitude (a delta sounding, ±0.5 echoes)
    and n_paths = 3: ``lax.top_k`` keeps the lowest three delays, and so
    does the port's stable sort."""
    tx = np.zeros(64, np.complex64)
    tx[0] = 1.0
    rx = np.zeros(64, np.complex64)
    rx[[0, 5, 9, 13, 17]] = [1.0, 0.5, -0.5, 0.5j, -0.5j]
    mag = np.abs(np.asarray(ref_pr.freq_domain_sound(jnp.asarray(tx), jnp.asarray(rx))[1]))
    assert mag[5] == mag[9] == mag[13] == mag[17]
    check_parity(pr.multipath_profile, ref_pr.multipath_profile, (tx, rx), {"n_paths": 4}, TOL)
    delays, _, valid = pr.multipath_profile(torch.from_numpy(tx), torch.from_numpy(rx), 4)
    assert delays[valid].tolist() == [0, 5, 9, 13]


def test_profile_and_modes_against_jax():
    rng = np.random.default_rng(2)
    tx = _cplx(rng, 1024)
    rx = (tx + 0.5 * np.roll(tx, 37) + 0.2j * np.roll(tx, 90)).astype(np.complex64)
    check_parity(pr.multipath_profile, ref_pr.multipath_profile, (tx, rx), {"n_paths": 8}, TOL)
    f = np.linspace(2e6, 30e6, 300)
    resp = (np.exp(-((f - 7e6) / 1e6) ** 2) + 0.6 * np.exp(-((f - 14e6) / 1e6) ** 2)
            + 0.4 * np.exp(-((f - 22e6) / 5e5) ** 2))
    check_parity(pr.mode_sound, ref_pr.mode_sound, (resp, f), {}, TOL)


def test_static_two_ray_fde_case_against_jax():
    """tests/test_fleet_fading.py:36-75 on the reference's key-9 draws: the
    JAX chain and the port's `two_ray_fde_case` give the same estimate
    (within LSTSQ_TOL) and taps, and both decode every byte."""
    name, rate, delay, amp, snr, data, key = entry.TWO_RAY_FDE_CASE
    wf = ref_create_waveform(name, rate)
    preamble = bytes(np.random.default_rng(0).integers(0, 256, 16))
    tx_pre = np.asarray(wf.modulate(preamble))
    tx = np.concatenate([tx_pre, np.asarray(wf.modulate(data))])
    rx = np.asarray(ref_awgn(jax.random.key(key), ref_2ray(jnp.asarray(tx), delay_samples=delay,
                                                            amplitude=amp), snr))
    h = np.asarray(ref_pr.ls_channel_estimate(tx_pre[:2048], rx[:2048], n_taps=8))
    got = entry.two_ray_fde_case("cpu")
    assert got["ok"] and bytes.fromhex(got["bytes"]) == data
    compare(got["estimate"], h, LSTSQ_TOL)
    assert [d for d, _ in got["taps"]] == [i for i in range(8) if abs(h[i]) > 0.05]


def test_fading_gate_carries_the_two_ray_case():
    gate = entry.fading_gate("cpu", seeds=range(1))
    assert gate["results"][entry.TWO_RAY_LABEL]["ok"]
    assert entry.TWO_RAY_LABEL in gate["pass_rates"]


def test_blocks_tables_are_the_reference_tables():
    assert pr.BLOCKS == ref_pr.BLOCKS
