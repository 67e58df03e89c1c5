"""The multi-emitter scene engine, the loopback simulator and the HAL against
the JAX package's, paired with tests/test_sim_scenario.py and
tests/test_hal_specs.py.

- `threefry.fold_in` equals ``jax.random.fold_in``; the tensor threefry
  (`random_bits_tensor`, `normal_tensor`) equals the numpy one bit for bit.
- Trajectories equal the reference's states to 1e-9 m (float64 on both).
- Every scene of tests/test_sim_scenario.py generated by both engines from
  the same config: IQ within `IQ_TOL` of the largest magnitude (the same
  threefry noise, whose normals differ from JAX's by 3e-7 relative; float32
  cos/sin of the same phases an ulp apart; complex products that XLA may
  fuse); the reference test's own bar on the port's IQ.
- The simulator: the same received samples as the reference for the same
  seed (its AWGN on the reference's key) within `IQ_TOL`; idle noise
  floor, injection, capabilities, loopback decode.
- The attenuator and the driver registry as the reference test holds them.
- `rf_scene_gate` on the CPU at a quarter second (30.72 MS/s, blocks of
  2^18, the jammer from 80 to 120 ms, 2^14 + 2^22 captured): every bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.sim import Simulator as RefSimulator
from r4w_tpu.sim import SimulatorConfig as RefSimulatorConfig
from r4w_tpu.sim import hal as ref_hal
from r4w_tpu.sim import scenario as ref
from r4w_tpu_torch import scene_gates
from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core import types
from r4w_tpu_torch.sim import Simulator, SimulatorConfig, discover_devices, hal
from r4w_tpu_torch.sim import scenario as port
from r4w_tpu_torch.waveforms import create_waveform

IQ_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(types, "DEFAULT_DEVICE", CPU)


@pytest.mark.parametrize("seed,data", [(0, 0), (5, 12345), (21, 0x7FFFFFFF), (7, 2 ** 31 + 3)])
def test_fold_in_equals_jax(seed, data):
    want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.key(seed), data)))
    assert threefry.fold_in(threefry.key(seed), data) == tuple(int(v) for v in want)


@pytest.mark.parametrize("n", [1, 1000, 1 << 18])
def test_tensor_threefry_equals_numpy(n):
    k = threefry.fold_in(threefry.key(3), n)
    np.testing.assert_array_equal(threefry.random_bits_tensor(k, n, CPU).numpy().astype(np.uint32),
                                  threefry.random_bits(k, n))
    np.testing.assert_array_equal(threefry.normal_tensor(k, (2, n), CPU).numpy(),
                                  threefry.normal(k, (2, n)))


def test_tensor_normals_equal_jax():
    k = jax.random.fold_in(jax.random.key(11), 77)
    want = np.asarray(jax.random.normal(k, (2, 4096)))
    got = threefry.normal_tensor(threefry.fold_in(threefry.key(11), 77), (2, 4096), CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=3e-7)


TRAJECTORIES = [
    ("static", (45.0, 7.0, 100.0), {}),
    ("linear", (45.0, 7.0, 0.0, (0.0, 100.0, 0.0)), {}),
    ("from_waypoints", ([(0.0, 45.0, 7.0, 0.0), (10.0, 45.0, 7.1, 0.0)],), {}),
    ("circular", (45.0, 7.0, 0.0), {"radius_m": 500.0, "omega_rad_s": 2 * np.pi / 60.0}),
]


@pytest.mark.parametrize("kind,args,kwargs", TRAJECTORIES)
def test_trajectories_equal_the_reference(kind, args, kwargs):
    got, want = getattr(port.Trajectory, kind)(*args, **kwargs), getattr(
        ref.Trajectory, kind)(*args, **kwargs)
    for t in (-5.0, 0.0, 5.0, 30.0, 60.0):
        a, b = got.state_at(t), want.state_at(t)
        np.testing.assert_allclose(a.position_ecef, b.position_ecef, rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.velocity_ecef, b.velocity_ecef, rtol=0, atol=1e-9)


def test_trajectory_reference_bars():
    tr = port.Trajectory.linear(45.0, 7.0, 0.0, (0.0, 100.0, 0.0))
    moved = np.linalg.norm(tr.state_at(10.0).position_ecef - tr.state_at(0.0).position_ecef)
    assert moved == pytest.approx(1000.0, rel=1e-6)
    omega = 2 * np.pi / 60.0
    circ = port.Trajectory.circular(45.0, 7.0, 0.0, radius_m=500.0, omega_rad_s=omega)
    half = circ.state_at(30.0).position_ecef - circ.state_at(0.0).position_ecef
    assert np.linalg.norm(half) == pytest.approx(1000.0, rel=1e-3)


def _scene(mod, name):
    """The scenes of tests/test_sim_scenario.py, built from module `mod`
    (the port's engine on the CPU)."""
    rx = mod.Trajectory.static(45.0, 7.0, 0.0)
    kw = {} if mod is ref else {"device": CPU}
    if name == "tone_doppler":
        cfg = mod.SceneConfig(sample_rate=250_000.0, duration_s=0.05, block_size=4096)
        em = [mod.ToneEmitter(id="tone", carrier_hz=1e9, power_dbm=30.0, offset_hz=10_000.0,
                              trajectory=mod.Trajectory.linear(45.0, 7.0127, 0.0,
                                                               (-300.0, 0.0, 0.0)))]
        return mod.ScenarioEngine(cfg, em, rx, reference_power_dbm=-70.0, **kw)
    if name == "power_scaling":
        cfg = mod.SceneConfig(sample_rate=250_000.0, duration_s=0.02)
        em = [mod.ToneEmitter(id=n, carrier_hz=1e9, power_dbm=p, offset_hz=o,
                              trajectory=mod.Trajectory.static(45.0, 7.0127, 0.0))
              for p, o, n in ((30.0, 10e3, "strong"), (10.0, -30e3, "weak"))]
        return mod.ScenarioEngine(cfg, em, rx, reference_power_dbm=-70.0, **kw)
    if name == "activity":
        cfg = mod.SceneConfig(sample_rate=100_000.0, duration_s=0.02, block_size=1000)
        em = [mod.ToneEmitter(id="burst", carrier_hz=1e9, power_dbm=40.0, offset_hz=10e3,
                              t_on=0.01, trajectory=mod.Trajectory.static(45.0, 7.01, 0.0))]
        return mod.ScenarioEngine(cfg, em, rx, reference_power_dbm=-70.0, **kw)
    if name == "waveform":
        cfg = mod.SceneConfig(sample_rate=125_000.0, duration_s=0.05, noise_figure_db=3.0)
        em = [mod.WaveformEmitter(id="bpsk", carrier_hz=433e6, power_dbm=30.0,
                                  waveform_name="BPSK", payload=bytes([0xC4, 0x7E]),
                                  sample_rate=125_000.0,
                                  trajectory=mod.Trajectory.static(45.0, 7.001, 0.0))]
        return mod.ScenarioEngine(cfg, em, rx, reference_power_dbm=-40.0, **kw)
    if name == "noise_jammer":
        cfg = mod.SceneConfig(sample_rate=250_000.0, duration_s=0.02)
        em = [mod.NoiseJammerEmitter(id="j", carrier_hz=1e9, power_dbm=40.0,
                                     trajectory=mod.Trajectory.static(45.0, 7.01, 0.0))]
        return mod.ScenarioEngine(cfg, em, rx, reference_power_dbm=-70.0, **kw)
    if name == "quiet":
        cfg = mod.SceneConfig(sample_rate=250_000.0, duration_s=0.02)
        return mod.ScenarioEngine(cfg, [], rx, **kw)
    if name == "sweep":
        cfg = mod.SceneConfig(sample_rate=250_000.0, duration_s=0.02)
        em = [mod.SweepJammerEmitter(id="sw", carrier_hz=1e9, power_dbm=40.0, sweep_hz=100e3,
                                     period_s=0.01,
                                     trajectory=mod.Trajectory.static(45.0, 7.01, 0.0))]
        return mod.ScenarioEngine(cfg, em, rx, reference_power_dbm=-70.0, **kw)
    raise KeyError(name)


SCENES = ("tone_doppler", "power_scaling", "activity", "waveform", "noise_jammer", "quiet",
          "sweep")


@pytest.fixture(scope="module")
def generated():
    """Each scene's IQ from both engines (the port's on the CPU)."""
    out = {}
    for name in SCENES:
        want = np.asarray(_scene(ref, name).generate_all())
        eng = _scene(port, name)
        assert eng.device.type == "cpu"
        out[name] = (eng.generate_all().numpy(), want)
    return out


@pytest.mark.parametrize("name", SCENES)
def test_engine_iq_equals_the_reference(generated, name):
    got, want = generated[name]
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.max(np.abs(got - want)) <= IQ_TOL * np.max(np.abs(want))


def _peak_freq(x, fs):
    spec = np.abs(np.fft.fft(x))
    k = int(np.argmax(spec))
    return (k - len(x) if k > len(x) // 2 else k) * fs / len(x)


def test_engine_reference_bars(generated):
    iq = generated["tone_doppler"][0]
    assert _peak_freq(iq, 250e3) == pytest.approx(10_000.0 + 300.0 * 1e9 / port.SPEED_OF_LIGHT,
                                                  abs=100.0)
    iq = generated["power_scaling"][0]
    spec = np.abs(np.fft.fft(iq)) ** 2
    n = len(iq)
    k_strong, k_weak = int(round(10e3 / 250e3 * n)), (int(round(-30e3 / 250e3 * n)) + n) % n
    assert 10 * np.log10(spec[k_strong] / spec[k_weak]) == pytest.approx(20.0, abs=1.5)
    iq = generated["activity"][0]
    assert np.mean(np.abs(iq[1100:2000]) ** 2) > 10 * np.mean(np.abs(iq[:900]) ** 2)
    assert (np.mean(np.abs(generated["noise_jammer"][0]) ** 2)
            > 100 * np.mean(np.abs(generated["quiet"][0]) ** 2))
    iq = generated["sweep"][0]
    f_inst = np.angle(iq[1:] * np.conj(iq[:-1])) * 250e3 / (2 * np.pi)
    assert f_inst.max() > 30e3 and f_inst.min() < -30e3


def test_waveform_emitter_decodable():
    eng = _scene(port, "waveform")
    iq = eng.generate_all()
    burst = len(eng.emitters[0]._burst)
    res = create_waveform("BPSK", 125_000.0, device="cpu").demodulate(iq[:burst])
    assert res.bits[:2].tolist() == [0xC4, 0x7E]


def test_block_phase_continuity_and_status():
    eng = _scene(port, "tone_doppler")
    x = torch.cat([eng.generate_block(2048), eng.generate_block(2048)]).numpy()
    f_inst = np.angle(x[1:] * np.conj(x[:-1])) * 250e3 / (2 * np.pi)
    assert np.all(np.abs(f_inst[2040:2056] - 11_000.6) < 500.0)
    st, want = _scene(port, "tone_doppler").emitter_status(0.0)[0], _scene(
        ref, "tone_doppler").emitter_status(0.0)[0]
    assert (st.range_m, st.doppler_hz, st.path_loss_db, st.active) == pytest.approx(
        (want.range_m, want.doppler_hz, want.path_loss_db, want.active), rel=1e-12)
    assert eng.progress == pytest.approx(4096 / 12500)
    eng.generate_all()
    assert eng.is_done and eng.progress == 1.0
    eng.reset()
    assert eng.progress == 0.0 and eng.generate_block(8).shape == (8,)


def test_simulator_channel_equals_the_reference():
    """inject → receive: the AWGN on the reference's key from the same
    default_rng, block after block; and the idle noise floor."""
    rng = np.random.default_rng(4)
    blocks = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
              for n in (1000, 777)]
    sim, want = Simulator(SimulatorConfig(channel_snr_db=12.0, seed=3), device=CPU), \
        RefSimulator(RefSimulatorConfig(channel_snr_db=12.0, seed=3))
    for b in blocks:
        sim.inject_signal(torch.from_numpy(b))
        want.inject_signal(b)
        got, ref_rx = sim.receive(len(b)).numpy(), np.asarray(want.receive(len(b)))
        assert np.max(np.abs(got - ref_rx)) <= IQ_TOL * np.max(np.abs(ref_rx))
    assert sim.sample_clock == want.sample_clock == 1777
    idle = Simulator(SimulatorConfig(noise_floor_db=-60.0), device=CPU).receive(4096).numpy()
    np.testing.assert_array_equal(idle, RefSimulator(RefSimulatorConfig(noise_floor_db=-60.0))
                                  .receive(4096))
    assert -63 < 10 * np.log10(np.mean(np.abs(idle) ** 2)) < -57


def test_simulator_loopback_injection_and_caps():
    sim = Simulator(SimulatorConfig(channel_snr_db=25.0), device=CPU)
    wf = create_waveform("QPSK", 125_000.0, device="cpu")
    tx = wf.modulate(b"simloop")
    assert sim.transmit(tx) == tx.shape[0]
    res = wf.demodulate(sim.receive(tx.shape[0]))
    assert bytes(res.bits[:7].numpy().astype(np.uint8)) == b"simloop"
    sim2 = Simulator(device=CPU)
    sim2.inject_signal(torch.ones(100, dtype=torch.complex64))
    assert float(torch.mean(torch.abs(sim2.receive(100)))) > 0.1
    caps = discover_devices()
    assert caps and dataclasses.astuple(caps[0]) == dataclasses.astuple(
        RefSimulator().capabilities())
    delayed = Simulator(SimulatorConfig(loopback_delay_samples=5), device=CPU)
    assert delayed.transmit(torch.ones(3, dtype=torch.complex64)) == 8


def test_attenuator_and_registry_as_the_reference():
    att, want = hal.DigitalAttenuator(), ref_hal.DigitalAttenuator()
    assert att.set_attenuation(10.1) == want.set_attenuation(10.1) == pytest.approx(10.0)
    assert att.total_loss_db == want.total_loss_db == pytest.approx(11.5)
    x = np.exp(1j * np.arange(8)).astype(np.complex64)
    np.testing.assert_array_equal(att.apply(torch.from_numpy(x)).numpy(),
                                  np.asarray(want.apply(jnp.asarray(x))))
    with pytest.raises(ValueError):
        att.set_attenuation(-3)
    assert att.set_attenuation(500.0) == att.spec.max_db
    assert att.sweep(0.0, 5.0, 1.0) == want.sweep(0.0, 5.0, 1.0)
    reg = hal.DriverRegistry()
    assert [dataclasses.astuple(i) for i in reg.list_drivers()] == [
        dataclasses.astuple(i) for i in ref_hal.DriverRegistry().list_drivers()]
    assert isinstance(reg.open("simulator"), Simulator)
    for name in ("uhd", "does-not-exist"):
        with pytest.raises(hal.DeviceNotFound):
            reg.open(name)


@pytest.fixture(scope="module")
def small_gate():
    prof = {"device": {"sample_rate": scene_gates.RATE_HZ, "frequency": 1e9},
            "profiles": {"scene": {"buffer": {"block_size": 1 << 18},
                                   "capture": {"pre_trigger_samples": 1 << 14,
                                               "post_trigger_samples": 1 << 22}}}}
    return scene_gates.rf_scene_gate("cpu", seconds=0.25, profile=prof, jammer=(0.08, 0.12))


def test_rf_scene_gate_bars_on_the_cpu(small_gate):
    out = small_gate
    assert out["ok"], out["bars"]
    assert out["payload"]["payload"] == scene_gates.PAYLOAD
    assert out["jammer"]["window"] == [1 << 14, (1 << 14) + 5 * (1 << 18)]
    assert out["samples"] == 7_680_000 and out["capture"].shape == ((1 << 14) + (1 << 22),)
    assert "r4w_scene_samples_total 7680000.0" in out["metrics_text"]
    assert '"core:datatype": "cf32_le"' in out["sigmf_meta"]
