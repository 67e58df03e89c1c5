"""Shared checks of the port's waveform fleet against the JAX package
(imported by tests/test_torch_fleet_*.py; not a test module).

For a factory name: the same payload gives the same IQ within a tolerance
relative to the reference's peak magnitude; the port's `demodulate` of
the reference's IQ, clean and with the reference's own AWGN draw (key 3,
the noisy matrix's) at the name's SNR, gives the reference's bits,
symbols and metadata.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from r4w_tpu.channel import awgn as ref_awgn
from r4w_tpu.waveforms import base as ref_base
from r4w_tpu.waveforms import create_waveform as ref_create_waveform
from r4w_tpu_torch.entry import ANALOG_BARS, BEACON_SNR_DB, CW_SNR_DB, DIGITAL_SNR, NOISY_DATA
from r4w_tpu_torch.waveforms import create_waveform

CPU = torch.device("cpu")
KEY = 3          # tests/test_fleet_noisy.py:18
MOD_TOL = 1e-5   # max|port - reference| / max|reference|: float32 cos/sin of equal phases
# Names whose phase is a float32 cumulative sum over the burst: XLA sums in
# float32 in its own order, torch's CPU cumsum accumulates in float64, so
# the phases part by a few float32 ulps of the largest phase.
CUMSUM_TOL = {"OOK": 1e-4, "BFSK": 2e-5}  # measured 2.3e-5 and 5.8e-6
# The beacons' audio phase is a float32 cumulative sum of Hz over one second
# (48,000 terms reaching 5e7, where one float32 ulp is 4): measured 6.9e-4.
BEACON_MOD_TOL = 2e-3
META_RTOL, META_ATOL = 1e-4, 1e-6
# Analog bytes are truncations of float32 audio that lands within an ulp of
# an integer for integer input; XLA's and torch's complex abs and angle
# part by an ulp, so a byte may truncate one code apart.
ANALOG_CODE_TOL = 1
# Beacon metadata counts envelope zero crossings per 50 ms window (10 Hz a
# crossing); an ulp of |x| may move a crossing near zero.
BEACON_FREQ_TOL_HZ = 20.0


REF_OWN_MODULES = "r4w_tpu.waveforms."  # a plugin's module is r4w_tpu_plugin_<name>


def ref_own_registry() -> dict:
    """The reference's registry (normalised name or alias -> builder) less
    what plugins added: the entries whose builder's module is one of the
    reference's own waveform modules. A test that loads a plugin
    (tests/test_mesh_registry.py) registers its names in the reference's
    process-global registry and never removes them."""
    return {alias: builder for alias, builder in ref_base._REGISTRY.items()
            if builder.__module__.startswith(REF_OWN_MODULES)}


def ref_own_waveforms() -> list[str]:
    """The reference's canonical names in registration order, less plugins'."""
    own = ref_own_registry()
    return [name for name in ref_base.list_waveforms() if ref_base._norm(name) in own]


def gate_snr(name: str) -> float:
    if name in DIGITAL_SNR:
        return DIGITAL_SNR[name][0]
    if name in ANALOG_BARS:
        return ANALOG_BARS[name][0]
    return CW_SNR_DB if name == "CW" else BEACON_SNR_DB


def gate_rate(name: str) -> float | None:
    return DIGITAL_SNR.get(name, (None, None))[1]


def waveforms(name: str, rate: float | None = None):
    """(port waveform on the CPU, reference waveform) at the gate's rate."""
    rate = rate or gate_rate(name)
    if rate:
        return create_waveform(name, rate, device=CPU), ref_create_waveform(name, rate)
    return create_waveform(name, device=CPU), ref_create_waveform(name)


def check_info(wf, ref) -> None:
    assert dataclasses.asdict(wf.info()) == dataclasses.asdict(ref.info())
    assert wf.samples_per_symbol() == ref.samples_per_symbol()
    assert dataclasses.asdict(wf.common_params) == dataclasses.asdict(ref.common_params)


def check_modulation(name: str, data=NOISY_DATA, tol: float | None = None) -> np.ndarray:
    """The port's IQ against the reference's; returns the reference's IQ."""
    wf, ref = waveforms(name)
    check_info(wf, ref)
    want = np.asarray(ref.modulate(data))
    got = wf.modulate(data)
    assert got.dtype == torch.complex64 and got.device == CPU
    got = got.numpy()
    assert got.shape == want.shape
    tol = tol if tol is not None else CUMSUM_TOL.get(name, MOD_TOL)
    err = np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30)
    assert err <= tol, f"{name}: max|Δ|/max {err:.3g} > {tol}"
    return want


def _check_metadata(name: str, got: dict, want: dict) -> None:
    assert set(got) == set(want), name
    for k, v in want.items():
        if isinstance(v, float):
            if k.startswith("audio_freq"):
                assert abs(got[k] - v) <= BEACON_FREQ_TOL_HZ, (name, k, got[k], v)
            elif k != "evm_rms":  # clean-signal EVM is rounding noise on both sides
                np.testing.assert_allclose(got[k], v, rtol=META_RTOL, atol=META_ATOL,
                                           err_msg=f"{name} {k}")
        else:
            assert got[k] == v, (name, k, got[k], v)


def check_decisions(name: str, iq: np.ndarray, noisy: bool) -> None:
    """The port's demodulation of the reference's IQ (with the reference's
    noise when `noisy`) against the reference's."""
    wf, ref = waveforms(name)
    if noisy:
        iq = np.asarray(ref_awgn(jax.random.key(KEY), iq, gate_snr(name)))
    want = ref.demodulate(iq)
    got = wf.demodulate(torch.from_numpy(np.array(iq)))
    want_bits, got_bits = np.asarray(want.bits), got.bits.numpy()
    if name in ANALOG_BARS:
        assert got_bits.shape == want_bits.shape
        signed_diff = (got_bits - want_bits + 128) % 256 - 128  # 255 and 0 are one code apart
        assert np.max(np.abs(signed_diff), initial=0) <= ANALOG_CODE_TOL, name
    else:
        np.testing.assert_array_equal(got_bits, want_bits, err_msg=name)
        np.testing.assert_array_equal(got.symbols.numpy(), np.asarray(want.symbols),
                                      err_msg=name)
    assert got.bits.device == CPU
    _check_metadata(name, got.metadata, want.metadata)
    if want.snr_estimate is None:
        assert got.snr_estimate is None
    elif noisy:
        np.testing.assert_allclose(got.snr_estimate, want.snr_estimate, rtol=1e-4, atol=1e-3)
