"""The port's PCPS acquisition against ``r4w_tpu.gnss.acquisition``.

Signals in the style of ``tests/test_gnss.py:80-127`` (C/A codes at a
code phase and Doppler, plus numpy noise), 2-3 PRNs at 1.023 and 2.046
MS/s over 1-4 code periods, go through both packages on the CPU.
Tolerances: the correlation grid within 1e-4 of its peak (float32 FFTs in
another order); acquisition decisions (detected, code phase, Doppler)
identical; peak metric and C/N0 within rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r4w_tpu.gnss import acquisition as ref_acq
from r4w_tpu.gnss import prn as ref_prn
from r4w_tpu_torch.gnss import acquisition

GRID_TOL = 1e-4  # max|Δ| / max(ref)
METRIC_RTOL = 1e-4
PRNS = [3, 9, 17]
PRESENT = ((3, 1000.0, 100), (9, -2000.0, 700))  # (PRN, Doppler Hz, code phase in chips)


def _signal(fs, periods, seed, snr_db=-12.0):
    """PRN 3 and 9 at their Dopplers and code phases, `periods` code
    periods at `fs`, complex Gaussian noise from a numpy generator."""
    sps = int(round(fs / 1.023e6))
    n = periods * 1023 * sps
    t = np.arange(n) / fs
    x = np.zeros(n, np.complex128)
    for p, dop, phase in PRESENT:
        code = np.tile(np.repeat(ref_prn.gps_ca_code(p).astype(np.float64), sps), periods)
        x += np.roll(code, phase * sps) * np.exp(2j * np.pi * dop * t)
    std = np.sqrt(10 ** (-snr_db / 10) / 2)
    rng = np.random.default_rng(seed)
    x += std * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _codes(fs, prns=PRNS):
    sps = int(round(fs / 1.023e6))
    return np.stack([np.repeat(ref_prn.gps_ca_code(p), sps) for p in prns]).astype(np.float32)


def _port(cfg):
    """The port's PcpsConfig with the reference config's fields."""
    return acquisition.PcpsConfig(**vars(cfg))


def _grids(x, codes, fs, cfg, **kw):
    want = np.asarray(ref_acq.pcps_grid(jnp.asarray(x), jnp.asarray(codes), fs, cfg, **kw))
    got = acquisition.pcps_grid(torch.from_numpy(x), torch.from_numpy(codes), fs, _port(cfg), **kw)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    return got.numpy(), want


def _close_grid(got, want):
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= GRID_TOL * np.max(want)


@pytest.mark.parametrize("fs", [1.023e6, 2.046e6])
@pytest.mark.parametrize("mode,periods", [("exact", 1), ("exact", 4), ("pow2", 3), ("auto", 2)])
def test_pcps_grid(fs, mode, periods):
    x = _signal(fs, periods, seed=periods)
    cfg = ref_acq.PcpsConfig(doppler_max_hz=3000.0, doppler_step_hz=500.0,
                             coherent_periods=periods, fft_mode=mode)
    got, want = _grids(x, _codes(fs), fs, cfg)
    _close_grid(got, want)
    assert np.array_equal(got.reshape(3, -1).argmax(-1)[:2], want.reshape(3, -1).argmax(-1)[:2])


def test_pcps_grid_dop_subset():
    fs = 2.046e6
    x = _signal(fs, 2, seed=5)
    cfg = ref_acq.PcpsConfig(coherent_periods=2)
    subset = np.array([-2250.0, -2000.0, 990.0, 1000.0], np.float32)
    got, want = _grids(x, _codes(fs), fs, cfg, dop_subset=subset)
    assert got.shape == (3, 4, 2046)
    _close_grid(got, want)


@pytest.mark.parametrize("budget", [6e5, 1.5e5])
def test_pcps_grid_chunked(budget):
    """A budget below three PRNs' live bytes chunks the PRN axis (6e5); one
    below a single PRN's (1.5e5) also chunks the Doppler axis. The chunked
    grid equals the unchunked one."""
    fs = 1.023e6
    x = _signal(fs, 2, seed=6)
    cfg = ref_acq.PcpsConfig(doppler_max_hz=2000.0, doppler_step_hz=500.0, coherent_periods=2,
                             memory_budget_bytes=budget)
    per_prn = 9 * 1023 * 8 * 4
    assert 3 * per_prn > budget and (per_prn <= budget) == (budget == 6e5)
    got, want = _grids(x, _codes(fs), fs, cfg)
    _close_grid(got, want)
    whole, _ = _grids(x, _codes(fs), fs, ref_acq.PcpsConfig(
        doppler_max_hz=2000.0, doppler_step_hz=500.0, coherent_periods=2))
    np.testing.assert_array_equal(got, whole)


def _acquire_both(x, codes, fs, cfg):
    want = ref_acq.acquire(jnp.asarray(x), jnp.asarray(codes), PRNS, fs, cfg)
    got = acquisition.acquire(torch.from_numpy(x), torch.from_numpy(codes), PRNS, fs, _port(cfg))
    for name in ("prn", "detected", "code_phase", "doppler_hz"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("peak_metric", "cn0_estimate"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=METRIC_RTOL, err_msg=name)
    return got


@pytest.mark.parametrize("align_refine", [True, False])
@pytest.mark.parametrize("fs,periods", [(1.023e6, 1), (1.023e6, 4), (2.046e6, 3)])
def test_acquire(fs, periods, align_refine):
    x = _signal(fs, periods, seed=10 + periods)
    cfg = ref_acq.PcpsConfig(doppler_max_hz=3000.0, doppler_step_hz=500.0,
                             coherent_periods=periods, align_refine=align_refine)
    got = _acquire_both(x, _codes(fs), fs, cfg)
    assert got.detected.tolist() == [True, True, False]


def test_sampled_code_bank_and_acquire_with_subphases():
    fs = 2.046e6
    waves = [ref_prn.gps_ca_code(p).astype(np.float32) for p in PRNS]
    bank = acquisition.sampled_code_bank(waves, 1.023e6, fs, 2046, n_subphases=4)
    want = ref_acq.sampled_code_bank(waves, 1.023e6, fs, 2046, n_subphases=4)
    assert bank.shape == (3, 4, 2046) and bank.dtype == np.float32
    np.testing.assert_array_equal(bank, want)
    x = _signal(fs, 3, seed=21)
    cfg = ref_acq.PcpsConfig(doppler_max_hz=3000.0, doppler_step_hz=500.0, coherent_periods=3)
    _acquire_both(x, bank, fs, cfg)


def test_doppler_bins_and_threshold_model():
    for cfg in (ref_acq.PcpsConfig(), ref_acq.PcpsConfig(doppler_max_hz=500.0,
                                                         doppler_step_hz=250.0)):
        port_cfg = _port(cfg)
        np.testing.assert_array_equal(acquisition.doppler_bins(port_cfg),
                                      ref_acq.doppler_bins(cfg))
        assert port_cfg.noise_max_estimate(41 * 2046) == cfg.noise_max_estimate(41 * 2046)


def test_argmax_takes_the_first_maximum():
    """jnp.argmax returns the first of equal maxima; so must the port."""
    x = np.zeros(2046, np.complex64)  # an all-zero grid: every bin ties
    cfg = ref_acq.PcpsConfig(doppler_max_hz=500.0, doppler_step_hz=250.0, coherent_periods=2,
                             align_refine=False)
    got = acquisition.acquire(torch.from_numpy(x), torch.from_numpy(_codes(1.023e6)), PRNS,
                              1.023e6, _port(cfg))
    want = ref_acq.acquire(jnp.asarray(x), jnp.asarray(_codes(1.023e6)), PRNS, 1.023e6, cfg)
    assert got.code_phase.tolist() == np.asarray(want.code_phase).tolist() == [0.0] * 3
    assert got.doppler_hz.tolist() == np.asarray(want.doppler_hz).tolist() == [-500.0] * 3
