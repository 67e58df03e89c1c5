"""The Galileo E1B receiver slice against the JAX package's on the same input.

- The host back end (``decode_sv_channel``) on symbol streams from
  ``build_sv_nav_symbols``, set up as ``tests/test_galileo_pvt_host.py``
  does (clean; noisy with the polarity flipped; too short for words 1-5):
  records and decoded ephemerides equal, transmit times within 1e-9 s.
- The front end (``e1b_receiver``) on one capture made by the JAX
  package's scenario engine (the gate's first two satellites, 0.4 s at
  5.115 MS/s) and fed to both packages: acquisition decisions, code phase
  and Doppler equal; the refined Doppler within 1e-3 Hz and the swept code
  phase within 1e-3 subchips (both come from open-loop prompts that agree
  to float32 rounding of sums over 20,460 samples, through a parabolic
  peak fit); the tracked code phase within 0.05 subchips. The E1B code
  is 49,104 subchips, so the per-block update is a float32 sum near
  49,104, whose rounding step is 2^-8 = 0.0039 subchips: a one-step
  difference in a block (the reference's compiled scan may fuse or
  reorder it) is carried by the 1 Hz DLL for a few blocks before it is
  absorbed; 0.05 subchips is 13 such steps, 1.2 m of range, and a
  twelfth of the 0.6 subchip (0.05 chip) that PR 7's C/A tolerance
  allowed. Carrier 0.1 Hz; prompts 1e-3 of the channel's largest.
- The entry point on the CPU at 0.4 s: every SV acquired and tracked,
  nothing decoded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r4w_tpu.gnss.acquisition as ref_acquisition
import r4w_tpu.gnss.scenario as ref_scenario
import r4w_tpu.gnss.tracking as ref_tracking
from r4w_tpu.gnss.ephemeris import circular_ephemeris_for_position
from r4w_tpu_torch.entry import galileo_pvt
from r4w_tpu_torch.gnss import galileo_pvt as port
from r4w_tpu_torch.gnss.scenario import SUBCHIP
from tools import galileo_pvt as ref

CODE_LEN = 4092.0 * SUBCHIP
T_TX_TOL_S = 1e-9
DOP_REF_TOL_HZ = 1e-3
PHASE_REF_TOL = 1e-3  # subchips
CODE_PHASE_TOL = 0.05  # subchips
FREQ_TOL = 0.1  # Hz
PROMPT_REL_TOL = 1e-3
CAPTURE_S = 0.4


@pytest.fixture(autouse=True)
def one_thread():
    """Tracking runs one small block at a time; torch's CPU thread pool
    costs more than it saves at that size."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_geometry_and_symbols_equal_the_reference():
    truth, sats = port._geometry()
    ref_truth, ref_sats = ref._geometry()
    np.testing.assert_array_equal(truth, ref_truth)
    np.testing.assert_array_equal(sats, ref_sats)
    tow_w5 = port.T0_SOW + (250 + 4 * 500) * port.T_EP
    for i in (0, 3):
        eph = circular_ephemeris_for_position(sats[i], truth, port.T0_SOW + 10.9, prn=i + 1,
                                              toe_quantum=60.0)
        got = port.build_sv_nav_symbols(eph, i + 1, tow_w5)
        np.testing.assert_array_equal(got, ref.build_sv_nav_symbols(eph, i + 1, tow_w5))
    cfg, _ = port.galileo_scenario()
    assert (cfg.seed, cfg.sample_rate, cfg.duration_s, len(cfg.satellites)) == (
        101, ref.FS, 11.2, 6)


def _host_setup(prn=3, k0=23, n=2740):
    """tests/test_galileo_pvt_host.py:_setup: clean prompt signs of one SV's
    stream from symbol k0."""
    truth = np.array([4500e3, 500e3, 4400e3])
    pos = np.array([20e6, 12e6, 16e6])
    pos *= 29.6e6 / np.linalg.norm(pos)
    t0 = 345_600.0
    tow_w5 = t0 + (250 + 4 * 500) * ref.T_EP
    eph = circular_ephemeris_for_position(pos, truth, t0 + 10.9, prn=prn, toe_quantum=60.0)
    syms = ref.build_sv_nav_symbols(eph, prn, tow_w5)
    return (1.0 - 2.0 * syms[k0:k0 + n]).astype(np.float64)


@pytest.mark.parametrize("case", ["clean", "noisy_flipped", "short"])
def test_decode_sv_channel_equals_the_reference(case):
    prn, m_star, cp0 = 3, 2650, 100.0
    prompt_i = _host_setup(prn)
    if case == "noisy_flipped":
        prn, cp0 = 5, 4000.0
        prompt_i = _host_setup(prn)
        prompt_i = -(prompt_i + 0.35 * np.random.default_rng(0).standard_normal(len(prompt_i)))
    elif case == "short":
        prompt_i, m_star, cp0 = prompt_i[:1400], 1000, 0.0
    code_phase = np.full(len(prompt_i) - 1, cp0)
    rec, eph, t_tx = port.decode_sv_channel(prompt_i, code_phase, cp0, m_star, prn, CODE_LEN,
                                            device="cpu")
    ref_rec, ref_eph, ref_t_tx = ref.decode_sv_channel(prompt_i, code_phase, cp0, m_star, prn,
                                                       CODE_LEN)
    assert rec == ref_rec
    if case == "short":
        assert eph is ref_eph is None and t_tx is ref_t_tx is None
        return
    assert rec["words"] == [1, 2, 3, 4, 5] and rec["wn"] == ref.WN
    assert vars(eph).keys() == vars(ref_eph).keys()
    for k in vars(eph):
        np.testing.assert_array_equal(np.asarray(vars(eph)[k]), np.asarray(vars(ref_eph)[k]))
    assert abs(t_tx - ref_t_tx) <= T_TX_TOL_S


def _capture(n_sats=2, duration_s=CAPTURE_S):
    """The gate's first satellites (I/NAV, seed 101) generated by the JAX package."""
    cfg, _ = port.galileo_scenario(duration_s)
    sats = tuple(ref_scenario.SatelliteConfig(**vars(s)) for s in cfg.satellites[:n_sats])
    ref_cfg = ref_scenario.ScenarioConfig(
        sample_rate=cfg.sample_rate, duration_s=duration_s, satellites=sats,
        receiver=ref_scenario.ReceiverConfig(lat_deg=45.0, lon_deg=7.0), seed=cfg.seed)
    return ref_scenario.GnssScenario(ref_cfg).generate(duration_s), [s.prn for s in sats]


def test_e1b_receiver_on_the_same_iq(monkeypatch):
    seen = {}
    acquire, init_state = ref_acquisition.acquire, ref_tracking.init_state

    def spy_acquire(*args, **kwargs):
        seen["acquire"] = acquire(*args, **kwargs)
        return seen["acquire"]

    def spy_init(cfg, phase, dop):  # the last call seeds the closed loop
        seen["init"] = (np.asarray(phase), np.asarray(dop))
        return init_state(cfg, phase, dop)

    monkeypatch.setattr(ref_acquisition, "acquire", spy_acquire)
    monkeypatch.setattr(ref_tracking, "init_state", spy_init)
    iq, prns = _capture()
    want = ref.e1b_receiver(jnp.asarray(iq), prns)
    got = port.e1b_receiver(torch.from_numpy(iq), prns)

    acq = seen["acquire"]
    np.testing.assert_array_equal(got["det"], np.asarray(acq.detected))
    np.testing.assert_array_equal(got["dop"], np.asarray(acq.doppler_hz, np.float64))
    tau = np.asarray(acq.code_phase, np.float64)
    scps = ref.CHIP_RATE * SUBCHIP / ref.FS
    np.testing.assert_array_equal(got["phase0"], (CODE_LEN - (tau - np.floor(tau)) * scps)
                                  % CODE_LEN)
    for key in ("det", "istart", "bs", "code_len"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["det"].all() and got["prompt_i"].shape == want["prompt_i"].shape == (2, 99)
    assert np.abs(got["dop_ref"] - seen["init"][1]).max() <= DOP_REF_TOL_HZ
    assert np.abs(seen["init"][0] - want["phase_ref"]).max() <= 1e-5  # the closed loop's seed
    assert np.abs(got["phase_ref"] - want["phase_ref"]).max() <= PHASE_REF_TOL
    dphase = np.abs(got["code_ph"] - want["code_ph"])
    assert np.minimum(dphase, CODE_LEN - dphase).max() <= CODE_PHASE_TOL
    assert np.abs(got["carr_freq"] - want["carr_freq"]).max() <= FREQ_TOL
    scale = np.abs(want["prompt_i"]).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got["prompt_i"] - want["prompt_i"]) <= PROMPT_REL_TOL * scale)


def test_open_windows_clamp_as_dynamic_slice():
    """A window that would run past the capture starts earlier, as
    ``lax.dynamic_slice`` moves it."""
    rx = torch.arange(100)
    samples, start = port._windows(rx, np.array([5, 30]), 80)
    assert start.tolist() == [5, 20] and samples.shape == (100,)
    samples, start = port._windows(rx, np.array([5, 12]), 60)
    assert start.tolist() == [5, 12] and samples.shape == (72,)


def test_entry_point_runs_the_receiver_on_the_cpu():
    """The whole chain at 0.4 s: too short for a page, so nothing decodes,
    but every SV is acquired and tracked and the stage times reported."""
    out = galileo_pvt("cpu", duration_s=CAPTURE_S)
    assert out["acquired"] == out["of"] == 6 and out["decoded"] == 0 and not out["pass"]
    assert out["device"] == "cpu" and out["mode"] == "decoded_ephemeris"
    assert all(out[k] > 0 for k in ("gen_s", "acquire_s", "track_s"))
    assert [r["prn"] for r in out["per_sv"]] == list(range(1, 7))
