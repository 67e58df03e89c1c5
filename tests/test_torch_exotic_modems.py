"""The port's ``ops.exotic_modems`` against ``r4w_tpu.ops.exotic_modems`` on
the same numpy inputs, made from seeds; then the JAX package's own tests of
it (``tests/test_exotic_modems.py``) run on the port.

Every decision is exact, but the optical receiver's: its 4th-power loop
locks the QPSK points onto the decision boundaries, so its decisions are
compared where they are not float32 ties (`modem_gates.decisive`).
Floats are max|port − reference| / max|reference| within TOL (float32
products, transforms, sums and the carrier loop in another order), but
the tones of the WSJT and FSK modems: their symbol-boundary phase is a
float32 cumulative sum that the reference's scan rounds at every partial
sum and the port rounds once (from float64), so the phase differs by a
few float32 spacings at its largest value; the bar is PHASE_ULPS of those
spacings, in absolute sample units (|sample| = 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.ops import exotic_modems as ref_xm
from r4w_tpu_torch.modem_gates import decisive
from r4w_tpu_torch.ops import exotic_modems as xm
from r4w_tpu_torch.waveforms.linear_mod import psk_constellation
from torch_port_proxy import run_reference_test

TOL = 2e-6         # float32 products, sums and the carrier loop in another order (measured 4.1e-7)
PHASE_ULPS = 8     # float32 spacings of the largest phase (measured 2)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0))


def _iq(rng, *shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _phase_bar(n_sym: int, sym_s: float, top_hz: float) -> float:
    """PHASE_ULPS float32 spacings at the largest phase a transmission reaches."""
    return PHASE_ULPS * float(np.spacing(np.float32(2 * np.pi * top_hz * n_sym * sym_s)))


@pytest.mark.parametrize("kind,n_sym", [("jt65", 30), ("wspr", 40), ("wspr", 162)])
def test_wsjt_against_jax(kind, n_sym):
    rng = np.random.default_rng(n_sym)
    tones = 65 if kind == "jt65" else 4
    syms = rng.integers(0, tones, n_sym)
    mod, demod = getattr(xm, f"{kind}_modulate"), getattr(xm, f"{kind}_demodulate")
    rmod, rdemod = getattr(ref_xm, f"{kind}_modulate"), getattr(ref_xm, f"{kind}_demodulate")
    x, rx = mod(_t(syms)), np.asarray(rmod(jnp.asarray(syms)))
    sym_s = 0.372 if kind == "jt65" else 0.6827
    spacing = 2.6917 if kind == "jt65" else 1.4648
    bar = _phase_bar(n_sym, sym_s, 1270.5 + (tones - 1) * spacing)
    assert float(np.max(np.abs(x.numpy() - rx))) < bar
    noisy = rx + 0.5 * _iq(rng, rx.shape[0])
    np.testing.assert_array_equal(demod(_t(noisy)).numpy(), np.asarray(rdemod(noisy)))
    np.testing.assert_array_equal(demod(x).numpy(), syms)


def test_underwater_and_plc_against_jax():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 50)
    x, rx = xm.underwater_modulate(_t(bits)), np.asarray(ref_xm.underwater_modulate(bits))
    assert float(np.max(np.abs(x.numpy() - rx))) < _phase_bar(50, 0.01, 11000.0)
    echo = rx + 0.4 * np.roll(rx, 37)
    np.testing.assert_array_equal(xm.underwater_demodulate(_t(echo)).numpy(),
                                  np.asarray(ref_xm.underwater_demodulate(echo)))
    bits = rng.integers(0, 2, 40)
    x, rx = xm.plc_modulate(_t(bits)), np.asarray(ref_xm.plc_modulate(bits))
    assert float(np.max(np.abs(x.numpy() - rx))) < _phase_bar(40, 1 / 2400.0, 85e3)
    t = np.arange(rx.shape[0]) / 250e3
    for jam in (0.0, 0.8):  # clean, then a narrowband interferer on carrier 0
        noisy = (rx + jam * np.exp(2j * np.pi * 75e3 * t)).astype(np.complex64)
        np.testing.assert_array_equal(xm.plc_demodulate(_t(noisy)).numpy(),
                                      np.asarray(ref_xm.plc_demodulate(noisy)))


def test_backscatter_and_vlc_against_jax():
    rng = np.random.default_rng(4)
    levels = np.repeat(np.where(rng.integers(0, 2, 48) > 0, 1.0, -1.0), 12)
    x = (levels + 2.0 + 0.1 * rng.standard_normal(levels.shape[0])).astype(np.complex64)
    np.testing.assert_array_equal(xm.rfid_backscatter_decode(_t(x), 40e3, 1e6).numpy(),
                                  np.asarray(ref_xm.rfid_backscatter_decode(x, 40e3, 1e6)))
    env = (1.0 + 0.3 * np.repeat(rng.integers(0, 2, 8), 64)
           + 0.02 * rng.standard_normal(512)).astype(np.float32)
    for sig in (env, env.astype(np.complex64)):
        got, want = xm.ambient_backscatter_detect(_t(sig)), ref_xm.ambient_backscatter_detect(sig)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert _rel(got[1], want[1]) < TOL
    bits = rng.integers(0, 2, 64)
    for kw in ({}, {"sps": 16, "kind": "vppm", "dimming": 0.25},
               {"sps": 10, "kind": "vppm", "dimming": 0.95}):
        w = xm.vlc_modulate(_t(bits), **kw)
        np.testing.assert_array_equal(w.numpy(), np.asarray(ref_xm.vlc_modulate(bits, **kw)))
    w = xm.vlc_modulate(_t(bits), 8)
    np.testing.assert_array_equal(xm.vlc_demodulate(w, 8).numpy(), bits)
    with pytest.raises(ValueError):
        xm.vlc_modulate(_t(bits), kind="laser")


def test_optical_wdm_mzi_against_jax():
    rng = np.random.default_rng(6)
    qpsk = psk_constellation(4)
    tx = (qpsk[rng.integers(0, 4, 3000)] * np.exp(1j * 0.6) * 3.0).astype(np.complex64)
    idx, y = xm.coherent_optical_receive(_t(tx), qpsk)
    ridx, ry = ref_xm.coherent_optical_receive(tx, qpsk)
    assert _rel(y, ry) < TOL
    # the loop locks the points onto the decision boundaries: decisions are
    # held equal where the reference's margin is not a float32 tie
    got, _ = decisive(idx, torch.from_numpy(np.asarray(ry)), qpsk)
    want, _ = decisive(torch.from_numpy(np.asarray(ridx)), torch.from_numpy(np.asarray(ry)), qpsk)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int((want >= 0).sum()) > 500  # the loop's pull-in: 543 of 3000 decisive
    chans = [np.repeat(rng.standard_normal(32), 64).astype(np.complex64) for _ in range(3)]
    mux = xm.wdm_mux([_t(c) for c in chans])
    rmux = ref_xm.wdm_mux([jnp.asarray(c) for c in chans])
    assert _rel(mux, rmux) < TOL
    assert _rel(xm.wdm_demux(mux, 3), ref_xm.wdm_demux(rmux, 3)) < TOL
    p = np.linspace(-np.pi, np.pi, 33).astype(np.float32)
    assert _rel(xm.photonic_mzi_transfer(_t(p)), ref_xm.photonic_mzi_transfer(p)) < TOL


@pytest.mark.parametrize("nc,n_fft,n_sym", [(64, 128, 4), (1536, 2048, 2)])
def test_dab_against_jax(nc, n_fft, n_sym):
    bits = np.random.default_rng(nc).integers(0, 2, 2 * nc * n_sym)
    x, cum = xm.dab_symbol_modulate(_t(bits), nc, n_fft)
    rx, rcum = ref_xm.dab_symbol_modulate(jnp.asarray(bits), nc, n_fft)
    assert _rel(cum, rcum) < TOL
    assert _rel(x, rx) < TOL
    np.testing.assert_array_equal(xm.dab_symbol_demodulate(x, nc, n_fft).numpy(),
                                  np.asarray(ref_xm.dab_symbol_demodulate(rx, nc, n_fft)))
    np.testing.assert_array_equal(xm.dab_symbol_demodulate(x, nc, n_fft).numpy(), bits)
    for mode in "ABCD":
        assert xm.drm_ofdm_params(mode) == ref_xm.drm_ofdm_params(mode)


def test_power_systems_against_jax():
    fs = 10_000.0
    t = np.arange(2000) / fs
    v = (1.5 * np.cos(2 * np.pi * 50.3 * t + 0.4)).astype(np.float32)
    for got, want in zip(xm.pmu_phasor(_t(v), fs, 50.0), ref_xm.pmu_phasor(v, fs, 50.0)):
        assert _rel(got, want) < TOL
    t = np.arange(4000) / fs
    h = (np.sin(2 * np.pi * 50 * t) + 0.1 * np.sin(2 * np.pi * 150 * t)).astype(np.float32)
    amps, thd = xm.harmonics_analyze(_t(h), fs, 50.0)
    ramps, rthd = ref_xm.harmonics_analyze(h, fs, 50.0)
    assert _rel(amps, ramps) < TOL and _rel(thd, rthd) < TOL
    base = np.sin(2 * np.pi * 50 * np.arange(100) / 5000.0)
    sig = np.concatenate([base, 0.5 * base, base + 0.3 * np.sin(6 * np.pi * 50 * np.arange(100)
                                                                 / 5000.0), 1.3 * base, 0 * base])
    assert xm.power_quality_classify(sig, 5000.0, device="cpu") == ref_xm.power_quality_classify(
        sig, 5000.0)
    state, rstate = (0.0, 0.0, 1.0), (0.0, 0.0, 1.0)
    v_ref = rv_ref = 2.0
    for _ in range(30):
        v_ref, state = xm.mppt_perturb_observe(v_ref, 10.0 - (v_ref - 5) ** 2, 0.1, state)
        rv_ref, rstate = ref_xm.mppt_perturb_observe(rv_ref, 10.0 - (rv_ref - 5) ** 2, 0.1, rstate)
    assert (v_ref, state) == (rv_ref, rstate)
    theta = np.linspace(0, 4 * np.pi, 50)
    for got, want in zip(xm.bldc_commutation(theta, 2), ref_xm.bldc_commutation(theta, 2)):
        np.testing.assert_array_equal(got, want)
    vals = np.asarray([-5.0, 0.0, 33.3, 100.0, 120.0], np.float32)
    ma = xm.industrial_4_20ma_encode(_t(vals), 0.0, 100.0)
    np.testing.assert_array_equal(ma.numpy(), np.asarray(ref_xm.industrial_4_20ma_encode(
        vals, 0.0, 100.0)))
    np.testing.assert_array_equal(xm.industrial_4_20ma_decode(ma, 0.0, 100.0).numpy(),
                                  np.asarray(ref_xm.industrial_4_20ma_decode(ma.numpy(), 0.0,
                                                                              100.0)))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bb84_is_the_references_draws(rate):
    a, b, q = xm.bb84_sift(None, 4000, rate, seed=3, device="cpu")
    ra, rb, rq = ref_xm.bb84_sift(None, 4000, rate, seed=3)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    assert q == rq


def test_blocks_table_is_the_references():
    assert xm.BLOCKS == ref_xm.BLOCKS


EXOTIC_TESTS = [
    "TestWsjt.test_jt65_roundtrip", "TestWsjt.test_wspr_roundtrip_with_noise",
    "TestWsjt.test_phase_continuity", "TestAcousticPlc.test_underwater_roundtrip_multipath",
    "TestAcousticPlc.test_plc_roundtrip_with_narrowband_noise",
    "TestBackscatter.test_rfid_fm0_decode", "TestBackscatter.test_ambient_backscatter",
    "TestVlcOptical.test_vlc_manchester_roundtrip", "TestVlcOptical.test_vppm_dimming_duty",
    "TestVlcOptical.test_coherent_receiver_fixes_phase", "TestVlcOptical.test_wdm_mux_demux",
    "TestVlcOptical.test_mzi_transfer", "TestDab.test_dab_dqpsk_roundtrip",
    "TestDab.test_drm_params", "TestPower.test_pmu_estimates_offnominal_freq",
    "TestPower.test_harmonics_thd", "TestPower.test_power_quality_events",
    "TestPower.test_mppt_climbs_hill", "TestPower.test_bldc_sectors",
    "TestPower.test_4_20ma_roundtrip", "TestQkd.test_bb84_clean_and_noisy",
]


@pytest.mark.parametrize("name", EXOTIC_TESTS)
def test_reference_exotic_tests_on_the_port(monkeypatch, name):
    run_reference_test(monkeypatch, "test_exotic_modems", name,
                       xm="r4w_tpu_torch.ops.exotic_modems", mp="r4w_tpu_torch.ops.mapping")
