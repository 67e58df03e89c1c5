"""The GPS L1 C/A receiver slice against the JAX package's on the same IQ.

Captures come from the JAX package's scenario engine (numpy IQ) and go
through both receivers on the CPU: ``tools/gps_pvt_fix.py`` and the
port's ``r4w_tpu_torch.gnss.gps_pvt_fix``.

- The code-phase gate (6 SVs, 10 ms at 8.184 MS/s): acquisitions
  identical, position error equal within 0.01 m.
- A reduced `l1ca_receiver` (2 SVs with LNAV, 0.5 s at 4.092 MS/s):
  acquisition and window starts identical, nav bits identical. The
  receiver's code phases start at 0 and sit just under 1023 chips, where
  one block's update sums to ~2046 chips and float32 steps by 1.2e-4
  chips; the reference's compiled scan contracts that update into a fused
  multiply-add, so some blocks differ by that step, and the 1 Hz DLL
  absorbs the difference over about 0.4 s. Tolerances there: code phase
  0.05 chips, carrier frequency 1 Hz, prompts 5% of the channel's
  largest prompt.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import r4w_tpu.gnss.acquisition as ref_acquisition
import r4w_tpu.gnss.pvt as ref_pvt
import r4w_tpu.gnss.scenario as ref_scenario
from r4w_tpu.waveforms import create_waveform as ref_create_waveform
from r4w_tpu_torch import create_waveform
from r4w_tpu_torch.entry import gps_pvt_fix, pcps_bench
from r4w_tpu_torch.gnss import gps_pvt_fix as port_fix
from r4w_tpu_torch.gnss import nav_message
from r4w_tpu_torch.waveforms.gnss_waveforms import GnssWaveform, GpsL1CaWaveform
from tools import gps_pvt_fix as ref_fix

PVT_TOL_M = 0.01
RCV_CODE_PHASE_TOL = 0.05  # chips
RCV_FREQ_TOL = 1.0  # Hz
RCV_PROMPT_REL_TOL = 0.05


@pytest.fixture(autouse=True)
def one_thread():
    """Tracking runs one small block at a time; torch's CPU thread pool
    costs more than it saves at that size."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy(monkeypatch, owner, name, store):
    orig = getattr(owner, name)

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        store[name] = out
        return out

    monkeypatch.setattr(owner, name, spy)


def test_code_phase_gate_on_the_same_iq(monkeypatch):
    seen = {}
    _spy(monkeypatch, ref_scenario.GnssScenario, "generate", seen)
    _spy(monkeypatch, ref_acquisition, "acquire", seen)
    _spy(monkeypatch, ref_pvt, "solve_position", seen)
    want = ref_fix.main_code_phase()
    got = port_fix.main_code_phase(device="cpu", iq=seen["generate"])
    assert got["device"] == "cpu" and got["acquired"] == want["acquired"] == 6 and got["pass"]
    np.testing.assert_array_equal(got["code_phase"], np.asarray(seen["acquire"].code_phase))
    np.testing.assert_array_equal(got["doppler_hz"], np.asarray(seen["acquire"].doppler_hz))
    truth, _ = ref_fix._geometry()
    ref_err = float(np.linalg.norm(np.asarray(seen["solve_position"].position_ecef) - truth))
    assert abs(got["value"] - ref_err) <= PVT_TOL_M
    assert round(got["value"], 1) == want["value"]


def _reduced_capture(n_sats=2, duration_s=0.5):
    """The decoded gate's first satellites (LNAV, range rates) generated by
    the JAX package."""
    cfg, _, _ = port_fix.decoded_scenario(duration_s)
    sats = tuple(ref_scenario.SatelliteConfig(**vars(s)) for s in cfg.satellites[:n_sats])
    ref_cfg = ref_scenario.ScenarioConfig(
        sample_rate=cfg.sample_rate, duration_s=duration_s, satellites=sats,
        receiver=ref_scenario.ReceiverConfig(lat_deg=45.0, lon_deg=7.0), seed=cfg.seed)
    return ref_scenario.GnssScenario(ref_cfg).generate(duration_s), [s.prn for s in sats]


def test_l1ca_receiver_on_the_same_iq():
    iq, prns = _reduced_capture()
    want = ref_fix.l1ca_receiver(jnp.asarray(iq), prns)
    got = port_fix.l1ca_receiver(torch.from_numpy(iq), prns)
    for key in ("det", "istart", "phase0", "bs"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["det"].all() and got["prompt_i"].shape == want["prompt_i"].shape == (2, 499)
    dphase = np.abs(got["code_ph"] - want["code_ph"])
    assert np.minimum(dphase, 1023.0 - dphase).max() <= RCV_CODE_PHASE_TOL
    assert np.abs(got["carr_freq"] - want["carr_freq"]).max() <= RCV_FREQ_TOL
    scale = np.abs(want["prompt_i"]).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got["prompt_i"] - want["prompt_i"]) <= RCV_PROMPT_REL_TOL * scale)
    for g, w in zip(got["prompt_i"], want["prompt_i"]):
        edge = nav_message.find_bit_edge(g)
        assert edge == nav_message.find_bit_edge(w)
        bits = nav_message.bits_from_prompts(g, edge)
        assert len(bits) >= 20
        np.testing.assert_array_equal(bits, nav_message.bits_from_prompts(w, edge))


def test_entry_point_runs_the_receiver_on_the_cpu():
    """The full chain at 0.3 s: too short for a frame, so nothing decodes,
    but every SV is acquired and tracked and the stage times are reported."""
    out = gps_pvt_fix("cpu", duration_s=0.3)
    assert out["acquired"] == out["of"] == 6 and out["decoded"] == 0 and not out["pass"]
    assert out["device"] == "cpu" and out["mode"] == "decoded_ephemeris"
    assert all(out[k] > 0 for k in ("gen_s", "acquire_s", "track_s"))
    assert [r["prn"] for r in out["per_sv"]] == list(range(1, 7))
    with pytest.raises(ValueError, match="CUDA"):
        pcps_bench("cpu")


def test_factory_gps_prn_names():
    wf = create_waveform("GPS-L1CA-PRN7", 4.092e6, device="cpu")
    ref = ref_create_waveform("GPS-L1CA-PRN7", 4.092e6)
    assert isinstance(wf, GpsL1CaWaveform) and wf.prn == 7 and wf.device == torch.device("cpu")
    tx = wf.modulate(b"\xa5\x3c")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(ref.modulate(b"\xa5\x3c")))
    res = wf.demodulate(tx)
    assert bytes(res.bits.numpy().astype(np.uint8)) == b"\xa5\x3c"
    assert res.symbols.tolist() == np.asarray(ref.demodulate(np.asarray(tx)).symbols).tolist()
    for name in ("GPS-L1CA-PRN33", "GPS-L1CA-PRN0", "GPS-L1CA-PRNx"):
        assert create_waveform(name, device="cpu") is None
        assert ref_create_waveform(name) is None
    assert create_waveform("GPS-L1CA-PRN32", device="cpu").prn == 32


@pytest.mark.parametrize("name", ["GPS-L1CA", "GPS-L5", "GLONASS-L1OF", "Galileo-E1"])
def test_factory_gnss_waveforms_match(name):
    wf, ref = create_waveform(name, 8.184e6, device="cpu"), ref_create_waveform(name, 8.184e6)
    assert isinstance(wf, GnssWaveform) and wf.info().name == ref.info().name
    assert wf.samples_per_symbol() == ref.samples_per_symbol()
    tx = wf.modulate(b"\x96")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(ref.modulate(b"\x96")))
    rng = np.random.default_rng(5)
    rx = (tx.numpy() + 0.5 * (rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape))
          ).astype(np.complex64)
    got, want = wf.demodulate(torch.from_numpy(rx)), ref.demodulate(jnp.asarray(rx))
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert got.snr_estimate == pytest.approx(want.snr_estimate, rel=1e-4)
