"""The port's scenario engine against ``r4w_tpu.gnss.scenario``.

Six configurations (GPS L1 C/A with LNAV bits, Galileo E1B, Galileo E1C
with its secondary code, GLONASS FDMA beside GPS, a multipath preset
starting near chip 0, and an orbital, trajectory-driven geometry with
atmospheric delays) go through both packages on the CPU.

- Host state (`_sat_state`, `status`, every `block_inputs` array) equals
  the reference's bit for bit, before and after a block.
- `composite_block` with zero noise against the reference run eagerly
  (op by op, so XLA fuses no multiply-add): max|Δ| ≤ 1e-5 of the block's
  peak amplitude. Both sides compute the chip positions with the same
  float32 operations, so no chip-boundary floor differs (counted: 0).
- The port's own noise has a standard deviation within 2% of
  `noise_std`; `state`/`restore` continues bit for bit.
- `load_scenario_yaml` on inline YAML equals the reference's result.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from r4w_tpu.gnss import scenario as ref_scenario
from r4w_tpu_torch.gnss import scenario

COMPOSITE_TOL = 1e-5  # max|Δ| / max|ref|
NOISE_STD_RTOL = 0.02
C = 299_792_458.0
# a range whose code phase at t = 0 sits one sub-chip past an epoch: the
# suburban preset's taps, delayed up to 1.47 sub-chips, start at negative
# positions
NEAR_EPOCH_RANGE_M = (0.070 - 1 / (1.023e6 * 12)) * C


def _case(mod, name):
    """The same ScenarioConfig built from `mod`'s dataclasses."""
    sat, cfg = mod.SatelliteConfig, mod.ScenarioConfig
    if name == "gps":
        bits = tuple(int(b) for b in 1 - 2 * (np.arange(40) % 3 == 0))
        sats = (sat(signal="GpsL1Ca", prn=7, cn0_dbhz=50.0, doppler_hz=1200.0, range_m=2.1e7,
                    nav_data=True, nav_bits=bits),
                sat(signal="GpsL1Ca", prn=12, cn0_dbhz=45.0, range_rate_mps=-300.0,
                    range_m=2.25e7, nav_data=True))
        return cfg(satellites=sats, sample_rate=2.046e6, seed=3)
    if name == "e1b":
        return cfg(satellites=(sat(signal="GalileoE1B", prn=3, cn0_dbhz=47.0, doppler_hz=-900.0,
                                   nav_data=True),), sample_rate=4.092e6, seed=4)
    if name == "e1c":
        return cfg(satellites=(sat(signal="GalileoE1C", prn=5, cn0_dbhz=47.0, doppler_hz=2100.0,
                                   range_m=2.4e7),
                               sat(signal="GalileoE1C", prn=11, cn0_dbhz=40.0,
                                   doppler_hz=-450.0)), sample_rate=4.092e6, seed=5)
    if name == "glonass":
        sats = tuple(sat(signal="GlonassL1of", prn=k + 8, cn0_dbhz=48.0, doppler_hz=300.0 * k,
                         carrier_offset_hz=k * 562_500.0) for k in (-7, 3))
        return cfg(satellites=sats + (sat(signal="GpsL1Ca", prn=7, cn0_dbhz=45.0),),
                   sample_rate=6.132e6, seed=6)
    if name == "multipath":
        sats = (sat(signal="GpsL1Ca", prn=2, cn0_dbhz=50.0, range_m=NEAR_EPOCH_RANGE_M,
                    elevation_deg=15.0, doppler_hz=500.0),
                sat(signal="GpsL1Ca", prn=9, cn0_dbhz=48.0, elevation_deg=75.0))
        return cfg(satellites=sats, sample_rate=4.092e6, seed=7,
                   environment=mod.EnvironmentConfig(multipath_preset="Suburban",
                                                     multipath_enabled=True))
    if name == "orbital":
        traj = mod.ReceiverTrajectory(start_lla=(45.0, 7.0, 250.0), end_lla=(45.2, 7.3, 900.0),
                                      speed_mps=250.0)
        sats = (sat(signal="GpsL1Ca", prn=4, cn0_dbhz=None, doppler_hz=1500.0,
                    orbital_dynamics=True, plane=1, slot=2, iono_delay_m=4.5,
                    tropo_delay_m=2.3),
                sat(signal="GalileoE1C", prn=8, cn0_dbhz=None, orbital_dynamics=True, plane=2,
                    slot=5))
        return cfg(satellites=sats, sample_rate=4.092e6, seed=8, start_time_gps_s=345_600.0,
                   duration_s=10.0,
                   receiver=mod.ReceiverConfig(lat_deg=45.0, lon_deg=7.0, alt_m=250.0,
                                               trajectory=traj))
    raise ValueError(name)


CASES = ("gps", "e1b", "e1c", "glonass", "multipath", "orbital")
BLOCK = 20_000  # samples a block: several code epochs at every rate


def _pair(name):
    return (scenario.GnssScenario(_case(scenario, name), device="cpu"),
            ref_scenario.GnssScenario(_case(ref_scenario, name)))


def _same_host_state(sc, ref, n):
    for t in (sc._t0, sc._t0 + 0.123):
        for got, want in zip(sc._sat_state(t), ref._sat_state(t)):
            np.testing.assert_array_equal(got, want)
    assert sc.status(0.05) == ref.status(0.05)
    (inputs, gen), (ref_inputs, _key) = sc.block_inputs(n), ref.block_inputs(n)
    assert isinstance(gen, torch.Generator)
    for got, want in zip(inputs, ref_inputs):
        assert got.dtype == {np.dtype(np.float32): torch.float32,
                             np.dtype(np.int32): torch.int32}[np.asarray(want).dtype]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(sc.sv_banks(), ref.sv_banks()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return inputs, ref_inputs


def _composite_pair(sc, ref, inputs, ref_inputs, n):
    fs = sc.config.sample_rate
    got = scenario.composite_block(*sc.sv_banks(), *inputs, 0.0, n=n, fs=fs,
                                   fdma_den=sc._fdma_den)
    with jax.disable_jit():
        want = np.asarray(ref_scenario.composite_block(
            *ref.sv_banks(), *ref_inputs, 0.0, jax.random.key(0), n=n, fs=fs,
            fdma_den=ref._fdma_den))
    return got.numpy(), want


@pytest.mark.parametrize("name", CASES)
def test_host_state_and_composite_match(name):
    sc, ref = _pair(name)
    assert sc.satellites == tuple(scenario.SatelliteConfig(**vars(s)) for s in ref.satellites)
    assert sc._noise_std == ref._noise_std and sc._fdma_den == ref._fdma_den
    for _ in range(2):  # at t = 0, then after one block (theta, n0, Doppler carried)
        inputs, ref_inputs = _same_host_state(sc, ref, BLOCK)
        got, want = _composite_pair(sc, ref, inputs, ref_inputs, BLOCK)
        assert got.dtype == np.complex64 and got.shape == (BLOCK,)
        err = np.abs(got - want)
        assert err.max() <= COMPOSITE_TOL * np.abs(want).max(), err.max() / np.abs(want).max()
        sc.generate_block(BLOCK)
        ref.generate_block(BLOCK)
    np.testing.assert_array_equal(sc._theta, ref._theta)
    assert (sc._t0, sc._n0) == (ref._t0, ref._n0)


def test_multipath_taps_start_before_chip_zero():
    """The near-epoch case: its delayed taps reach negative sub-chip
    positions at t = 0, and every gather index is still in range."""
    sc, _ = _pair("multipath")
    inputs, _ = sc.block_inputs(BLOCK)
    chips0, tap_delay = inputs[0].numpy(), sc._tap_delay.numpy()
    assert chips0[0] < tap_delay[0].max()
    out = scenario.composite_block(*sc.sv_banks(), *inputs, 0.0, n=64, fs=4.092e6)
    assert np.isfinite(out.numpy()).all()


def test_multipath_taps_and_trajectory_helpers():
    for preset in ("OpenSky", "Suburban", "UrbanCanyon", "Indoor"):
        for el in (10.0, 45.0, 75.0):
            assert scenario.multipath_taps(preset, el) == ref_scenario.multipath_taps(preset, el)
    args = ((45.0, 7.0, 250.0), (46.9, 7.4, 540.0), 30.0)
    traj, ref_traj = scenario.ReceiverTrajectory(*args), ref_scenario.ReceiverTrajectory(*args)
    assert traj.distance_m() == ref_traj.distance_m()
    assert traj.heading_deg() == ref_traj.heading_deg()
    for frac in (0.0, 0.3, 1.2):
        assert traj.position_at(frac) == ref_traj.position_at(frac)


def test_injected_noise_matches_reference_formula():
    """`noise=` (unit variance per component) scaled by noise_std, as the
    reference adds its own draws."""
    sc, ref = _pair("gps")
    inputs, ref_inputs = _same_host_state(sc, ref, 4096)
    rng = np.random.default_rng(2)
    unit = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    got = scenario.composite_block(*sc.sv_banks(), *inputs, sc._noise_std,
                                   noise=torch.from_numpy(unit), n=4096, fs=2.046e6).numpy()
    clean, want = _composite_pair(sc, ref, inputs, ref_inputs, 4096)
    noisy = want + unit * np.float32(sc._noise_std)
    assert np.abs(got - noisy).max() <= COMPOSITE_TOL * np.abs(noisy).max()
    with pytest.raises(ValueError):
        scenario.composite_block(*sc.sv_banks(), *inputs, 1.0, n=16, fs=2.046e6)


def test_noise_std_of_the_ports_generator():
    cfg = scenario.ScenarioConfig(satellites=(scenario.SatelliteConfig(
        signal="GpsL1Ca", prn=1, cn0_dbhz=-60.0),), sample_rate=2.046e6, seed=12)
    sc = scenario.GnssScenario(cfg, device="cpu")
    x = sc.generate_block(1 << 16).numpy()
    for part in (x.real, x.imag):
        assert abs(part.std() / sc._noise_std - 1.0) < NOISE_STD_RTOL
    gen = scenario.GnssScenario(cfg, device="cpu").generate(0.032)
    assert gen.dtype == np.complex64 and len(gen) == int(0.032 * 2.046e6)


def test_state_restore_continues_bit_for_bit():
    cfg = _case(scenario, "e1c")
    a = scenario.GnssScenario(cfg, device="cpu")
    a.generate_block(7000)
    snap = json.loads(json.dumps(a.state()))
    want = [a.generate_block(5000), a.generate_block(3000)]
    b = scenario.GnssScenario(cfg, device="cpu").restore(snap)
    for w in want:
        assert torch.equal(b.generate_block(len(w)), w)
    dev = scenario.GnssScenario(cfg, device="cpu").generate_device(0.004, block_size=5000)
    host = scenario.GnssScenario(cfg, device="cpu").generate(0.004, block_size=5000)
    assert dev.shape == (int(0.004 * 4.092e6),) and np.array_equal(dev.numpy(), host)


YAML = """
satellites:
  - signal: GalileoE1C
    prn: 3
    cn0_dbhz: 34
    doppler_hz: 1250.5
    orbital_dynamics: true
    plane: 1
    slot: 2
  - signal: GpsL1Ca
    prn: 7
    range_rate_mps: -120
    nav_data: true
    iono_delay_m: 3.5
receiver:
  position: {lat_deg: 41.07, lon_deg: -85.22, alt_m: 263.6}
  antenna: !Patch
    peak_gain_dbi: 4.5
  noise_figure_db: 2.5
  elevation_mask_deg: 10
  trajectory:
    start: {lat_deg: 41.07, lon_deg: -85.22, alt_m: 263.6}
    end: {lat_deg: 46.95, lon_deg: 7.45, alt_m: 540}
    speed_mps: 1000
    description: transatlantic
environment:
  multipath_preset: UrbanCanyon
  multipath_enabled: true
output:
  sample_rate: 4092000
  duration_s: 2.5
  start_time_gps_s: 345600
  format: cf32
  seed: 7
"""


def test_load_scenario_yaml_matches():
    got, want = scenario.load_scenario_yaml(YAML), ref_scenario.load_scenario_yaml(YAML)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.receiver.antenna == "patch" and got.seed == 7 and math.isclose(
        got.satellites[0].doppler_hz, 1250.5)
    with pytest.raises(FileNotFoundError):
        scenario.load_scenario_yaml("missing.yaml")
