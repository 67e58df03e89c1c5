"""The port's CW, OOK, ASK, FSK, PPM/ADS-B, AM/FM and beacon waveforms
against the JAX package (tests/torch_fleet_parity.py holds the checks and
their tolerances): IQ, and decisions on the reference's IQ clean and with
its own AWGN draw at the noisy matrix's SNR. The JAX fleet tests are in
the slow lane, so these are the quick lane's guard of this part of the
fleet."""

import numpy as np
import pytest
import torch

from r4w_tpu.waveforms import analog as ref_analog
from r4w_tpu.waveforms import beacon as ref_beacon
from r4w_tpu_torch.waveforms import analog, beacon, create_waveform
from torch_fleet_parity import (BEACON_MOD_TOL, CPU, check_decisions, check_modulation,
                                waveforms)

NAMES = ["CW", "OOK", "ASK", "4-ASK", "BFSK", "4-FSK", "PPM", "ADS-B", "AM-Broadcast",
         "FM-Broadcast", "NBFM"]
BEACONS = ["ELT-121.5", "EPIRB-121.5", "PLB-121.5", "Beacon-243"]


@pytest.mark.parametrize("name", NAMES + BEACONS)
def test_modulation_and_decisions_match_reference(name):
    iq = check_modulation(name, tol=BEACON_MOD_TOL if name in BEACONS else None)
    check_decisions(name, iq, noisy=False)
    check_decisions(name, iq, noisy=True)


def test_cw_frequency_and_power_match_reference():
    wf, ref = waveforms("CW", 125_000.0)
    iq = np.asarray(ref.modulate(b""))
    got, want = wf.demodulate(iq).metadata, ref.demodulate(iq).metadata
    assert abs(got["frequency"] - 1000.0) < 5.0
    np.testing.assert_allclose(got["frequency"], want["frequency"], rtol=1e-6)
    np.testing.assert_allclose(got["power"], want["power"], rtol=1e-6)


@pytest.mark.parametrize("name", ["AM-Broadcast", "NBFM"])
def test_audio_round_trip_matches_reference(name):
    """tests/test_waveform_fleet.py:71's 440 Hz tone through modulate_audio
    and demodulate_audio; the FM discriminator's (-π, π] wrap included."""
    t = np.arange(1000) / 125_000.0
    audio = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    wf, ref = waveforms(name, 125_000.0)
    iq = wf.modulate_audio(torch.from_numpy(audio))
    want = np.asarray(ref.modulate_audio(audio))
    np.testing.assert_allclose(iq.numpy(), want, atol=1e-5)
    got = wf.demodulate_audio(want).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.demodulate_audio(want)), atol=1e-5)
    if name == "AM-Broadcast":
        assert np.max(np.abs(got - audio)) < 0.02
    else:
        assert np.corrcoef(got[1:], audio[1:-1])[0, 1] > 0.99


def test_dsb_sc_and_wide_deviation_match_reference():
    """The AM DSB-SC coherent detector, and FM at 75 kHz deviation where
    the discriminator wraps."""
    audio = np.random.default_rng(0).uniform(-1, 1, 256).astype(np.float32)
    wf = analog.AM(device=CPU, variant="dsb_sc")
    ref = ref_analog.AM(variant="dsb_sc")
    iq = np.asarray(ref.modulate_audio(audio))
    np.testing.assert_allclose(wf.modulate_audio(torch.from_numpy(audio)).numpy(), iq, atol=1e-6)
    np.testing.assert_allclose(wf.demodulate_audio(iq).numpy(),
                               np.asarray(ref.demodulate_audio(iq)), atol=1e-5)
    fm, ref_fm = analog.FM(device=CPU), ref_analog.FM()
    iq = np.asarray(ref_fm.modulate_audio(audio))
    np.testing.assert_allclose(fm.demodulate_audio(iq).numpy(),
                               np.asarray(ref_fm.demodulate_audio(iq)), atol=1e-4)


def test_beacon_sweep_detected_on_its_own_signal():
    wf = create_waveform("ELT-121.5", device=CPU)
    tx = wf.modulate()
    assert tx.shape[0] == int(wf.common.sample_rate)
    md = wf.demodulate(tx).metadata
    ref_md = ref_beacon.Beacon().demodulate(np.asarray(ref_beacon.Beacon().modulate())).metadata
    assert md["sweep_detected"] == ref_md["sweep_detected"] == 1.0
    assert md["audio_freq_max"] > md["audio_freq_min"]


def test_adsb_preamble_and_length():
    wf, ref = waveforms("ADS-B", 8_000_000.0)
    np.testing.assert_array_equal(wf.adsb_preamble().numpy(), np.asarray(ref.adsb_preamble()))
    assert wf.modulate(b"\xa7\x1b").shape[0] == 8 * 8 + 2 * 8 * 8


def test_short_captures_give_empty_results():
    for name in ("OOK", "UWB", "Zigbee", "P25", "TETRA", "ALE", "3G-ALE", "Link-16"):
        res = create_waveform(name, device=CPU).demodulate(torch.zeros(3, dtype=torch.complex64))
        assert res.bits.numel() == 0 and res.symbols.numel() == 0, name


def test_beacon_rates_match_reference():
    for name in ("EPIRB-121.5", "PLB-121.5", "Beacon-243"):
        wf, ref = waveforms(name)
        assert wf.sweep_rate_hz == ref.sweep_rate_hz and wf.variant == ref.variant
    assert isinstance(create_waveform("ELT", device=CPU), beacon.Beacon)
