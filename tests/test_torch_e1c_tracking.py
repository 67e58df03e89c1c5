"""The Galileo E1C pilot chain against the JAX package's, paired with
tests/test_tracking_handoff.py and tests/test_e1b_inav_phase.py.

- `track_channels` on one capture (the port's scenario engine on the CPU:
  2 SVs at 42 dB-Hz, 9 code periods at 5 MS/s) and one acquisition tuple,
  fed to both packages: `detected`, `sec_shift` and `tracked` equal; the
  refined Doppler within `DOP_TOL_HZ`, the BOC jump within `JUMP_TOL`
  subchips, the lock within `LOCK_TOL`, the lock-based C/N0 within
  `CN0_TOL_DB`, the E-L bias within `EL_TOL`, `sec_dom` within `DOM_TOL`
  relative. The open-loop prompts come from float32 loops whose rounding
  differs from the reference's compiled scan by an ulp in some blocks
  (tests/test_torch_gnss_galileo.py), and every stage refines from them:
  the jump and the bias move by ~1e-3-1e-2 subchips, and at 42 dB-Hz the
  lock is within 1e-3 of 1, where its C/N0 (A²/(tot − A²)) divides by a
  small difference (measured 0.27 dB apart). At 9 periods no CS25 shift
  can dominate (`sec_dom` 1.0 on both), so nothing is tracked there.
- The 13 offsets of a code sweep as 13·P lanes of one `tracking.track`
  call equal 13 single calls.
- `tracking.track(wipe=)` equals tracking a capture multiplied first.
- Port only: tracked at 26 periods; I/NAV pages decoded off the pilot loop
  (the reference test's 2-SV dual scene, 3.3 s at 4.092 MS/s; marked slow
  as the reference's is), every CRC-ok page's data equal to the truth; the
  gate's scene as specified.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r4w_tpu.gnss.acquisition as ref_acquisition
from r4w_tpu_torch.gnss import acquisition, e1c_common, e1c_tracking, tracking
from r4w_tpu_torch.gnss import scenario as sc
from tools import e1c_tracking as ref

DOP_TOL_HZ = 0.05
JUMP_TOL = 0.01      # subchips
LOCK_TOL = 0.005
CN0_TOL_DB = 0.5
EL_TOL = 0.02
DOM_TOL = 1e-3
PERIODS = 9
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(prns_dops, cn0=42.0, fs=5e6, seed=7):
    sats = tuple(sc.SatelliteConfig(
        signal="GalileoE1C", prn=p, cn0_dbhz=cn0, doppler_hz=d, range_m=2.2e7,
        range_rate_mps=-d * sc.LIGHT_SPEED / sc.GALILEO_E1_HZ) for p, d in prns_dops)
    return sc.ScenarioConfig(satellites=sats, sample_rate=fs, seed=seed)


def _present(periods):
    cfg, rx, prns, n, waves, acq, _ = e1c_common.e1c_capture(
        _config([(3, -1234.0), (25, 987.0)]), periods, CPU)
    return cfg, rx, prns[:n], waves[:n], acquisition.AcquisitionResult(*[f[:n] for f in acq])


@pytest.fixture(scope="module")
def both():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, rx, prns, waves, acq = _present(PERIODS)
        got, _ = e1c_tracking.track_channels(rx, 5e6, prns, waves, acq, PERIODS, 42.0)
    finally:
        torch.set_num_threads(n)
    ref_acq = ref_acquisition.AcquisitionResult(
        **{k: jnp.asarray(v.numpy()) for k, v in acq._asdict().items()})
    want, _ = ref.track_channels(jnp.asarray(rx.numpy()), 5e6, prns, waves, ref_acq, PERIODS,
                                 42.0)
    return got, want


def test_track_channels_equals_the_reference(both):
    got, want = both
    assert [r["prn"] for r in got] == [r["prn"] for r in want] == [3, 25]
    for g, w in zip(got, want):
        for key in ("detected", "sec_shift", "tracked"):
            assert g[key] == w[key], (key, g, w)
        assert abs(g["dop_resid_hz"] - w["dop_resid_hz"]) <= DOP_TOL_HZ + 0.005, (g, w)
        assert abs(g["boc_jump_subchips"] - w["boc_jump_subchips"]) <= JUMP_TOL, (g, w)
        assert abs(g["lock"] - w["lock"]) <= LOCK_TOL + 0.0005, (g, w)
        assert abs(g["cn0_est_dbhz"] - w["cn0_est_dbhz"]) <= CN0_TOL_DB + 0.05, (g, w)
        assert abs(g["cn0_acq_dbhz"] - w["cn0_acq_dbhz"]) <= 0.05, (g, w)
        assert abs(g["el_bias"] - w["el_bias"]) <= EL_TOL + 0.00005, (g, w)
        assert g["sec_dom"] == pytest.approx(w["sec_dom"], rel=DOM_TOL, abs=0.005)


def test_sweep_lanes_equal_single_calls():
    """The 13 offsets as 13·P lanes of one call equal 13 calls of P lanes."""
    _, rx, prns, waves, acq = _present(PERIODS)
    cfg = tracking.TrackingConfig(code_length=4092 * sc.SUBCHIP, sample_rate=5e6,
                                  chipping_rate=sc.CHIP_RATE * sc.SUBCHIP, el_spacing=2.0,
                                  block_period=4092 / sc.CHIP_RATE, carrier_hz=sc.GALILEO_E1_HZ,
                                  dll_bandwidth=0.0, pll_bandwidth=0.0, fll_gain=0.0)
    codes = torch.from_numpy(np.stack(waves).astype(np.float32))
    start = np.floor(acq.code_phase.numpy()).astype(np.int64)
    dop = acq.doppler_hz.numpy().astype(np.float32)
    phases = (np.array([100.0, 2000.5])[None, :] + e1c_tracking.CAND[:, None]).astype(np.float32)
    st = tracking.init_state(cfg, phases.reshape(-1), np.tile(dop, 13), device=CPU)
    _, batched = tracking.track(cfg, st, rx, codes.repeat(13, 1), start=np.tile(start, 13))
    for m in range(13):
        _, one = tracking.track(cfg, tracking.init_state(cfg, phases[m], dop, device=CPU), rx,
                                codes, start=start)
        for field in ("prompt_i", "prompt_q", "dll_disc", "code_phase"):
            torch.testing.assert_close(getattr(batched, field)[2 * m: 2 * m + 2],
                                       getattr(one, field), rtol=0, atol=0)


def test_wipe_equals_a_premultiplied_capture():
    rng = np.random.default_rng(3)
    code = np.sign(rng.standard_normal(200)).astype(np.float32)
    x = torch.from_numpy((np.tile(code, 24) * np.exp(0.3j)).astype(np.complex64))
    cfg = tracking.TrackingConfig(code_length=200, sample_rate=200_000.0,
                                  chipping_rate=200_000.0, block_period=0.004)
    signs = np.sign(rng.standard_normal((2, 6, 4))).astype(np.float32)
    st = tracking.init_state(cfg, np.zeros(2, np.float32), np.zeros(2, np.float32), device=CPU)
    _, got = tracking.track(cfg, st, x, torch.from_numpy(code), start=[0, 0], wipe=signs)
    pre = x[None, :] * torch.from_numpy(np.repeat(signs.reshape(2, -1), 200, axis=1))
    _, want = tracking.track(cfg, st, pre, torch.from_numpy(code))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tracked_at_26_periods():
    """The fewest periods at which a CS25 shift can dominate (25 epochs of
    open-loop prompts); acquisition within ±1.5 kHz to keep the test short."""
    cfg = _config([(3, -1234.0), (25, 987.0)])
    n_per = e1c_common.samples_per_period(cfg.sample_rate)
    rx = sc.GnssScenario(cfg, device=CPU).generate_device(
        26 * n_per / cfg.sample_rate, block_size=e1c_common.GENERATE_BLOCK)[: 26 * n_per]
    prns, waves = [3, 25], e1c_common.e1c_waves([3, 25])
    codes = acquisition.sampled_code_bank(waves, sc.CHIP_RATE * sc.SUBCHIP, cfg.sample_rate,
                                          n_per, n_subphases=4)
    acq = acquisition.acquire(rx, codes, prns, cfg.sample_rate, acquisition.PcpsConfig(
        doppler_max_hz=1500.0, doppler_step_hz=125.0, threshold=1.0, coherent_periods=26))
    stages = {}
    per, track_s = e1c_tracking.track_channels(rx, cfg.sample_rate, prns, waves, acq, 26, 42.0,
                                               stages=stages)
    assert all(r["tracked"] for r in per), per
    assert all(r["lock"] > 0.9 and r["sec_dom"] > 1.3 for r in per), per
    for r, s in zip(per, cfg.satellites):
        assert abs(r["doppler_hz"] - s.doppler_hz) < 2.0, r
    assert set(stages) == {"sweep0", "joint_search", "code_sweep", "carrier_seed", "pilot_pass"}
    assert track_s >= sum(stages.values()) * 0.99


@pytest.mark.slow
def test_e1b_pages_decode_off_the_pilot_loop():
    """tests/test_e1b_inav_phase.py's scene on the port, on the CPU (~45 s
    on one thread: slow, as the reference's own test is)."""
    sats = tuple(sc.SatelliteConfig(signal="GalileoE1C", prn=p, cn0_dbhz=45.0, doppler_hz=d,
                                    range_m=r)
                 for p, d, r in ((3, 250.0, 21e6), (7, -410.0, 23e6)))
    cfg = sc.ScenarioConfig(satellites=sats, sample_rate=4.092e6, duration_s=1.0, seed=11)
    out = e1c_tracking.e1b_inav_phase(cfg, periods=50, duration_s=3.3, device="cpu")
    assert out["pass"] and out["svs_pages_ok"] == 2, out["per_sv"]
    truth, _ = e1c_tracking.inav_pages(out["epochs"], sats)
    for sv in out["per_sv"]:
        assert sv["pages_crc_ok"] >= 1 and sv["pages_data_match"] == sv["pages_crc_ok"]
        assert all(d in [t.tolist() for t in truth[sv["prn"]]] for d in sv["data112"])


def test_gate_scene_and_memo():
    cfg = e1c_common.gate_config()
    assert [s.prn for s in cfg.satellites] == [3, 25, 8, 2, 5, 16, 13, 15]
    assert cfg.sample_rate == 5e6 and cfg == e1c_common.gate_config()
    for s in cfg.satellites:
        assert s.signal == "GalileoE1C" and s.cn0_dbhz == 34.0
        assert abs(s.doppler_hz) <= 3000.0 and 2.0e7 <= s.range_m <= 2.6e7
        assert s.doppler_hz % 125.0 != 0.0  # off the acquisition grid
        assert s.range_rate_mps == pytest.approx(-s.doppler_hz * sc.LIGHT_SPEED
                                                 / sc.GALILEO_E1_HZ)
    first = e1c_common.e1c_capture(_config([(3, -1234.0), (25, 987.0)]), PERIODS, CPU)
    assert e1c_common.e1c_capture(_config([(3, -1234.0), (25, 987.0)]), PERIODS, CPU) is first
    assert first[2] == [3, 25, 9, 30] and first[3] == 2
    assert not bool(first[5].detected[2:].any())
