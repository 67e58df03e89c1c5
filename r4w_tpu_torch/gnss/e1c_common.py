"""Shared Galileo E1C capture for the pilot gates.

PyTorch counterpart of the JAX package's ``tools/e1c_common.py``: a
scenario (a `ScenarioConfig`, or a YAML path read by
`load_scenario_yaml`) generated for K code periods on the device, the
absent-PRN false-alarm controls (9, 30, 44) added to its PRNs, a
4-subphase sampled code bank, and PCPS acquisition of every PRN over the
K periods. Generation and acquisition are the expensive steps, so each
(scenario, K, device) is made once per process, keyed as the reference
keys it (a YAML file by its absolute path).

`gate_config()` builds in code the 8-SV scene of the reference's
E1C record (PRNs 3, 25, 8, 2, 5, 16, 13, 15 at C/N0 34 dB-Hz, 5 MS/s),
which the reference reads from ``e1c_8prn_60s_cn34_orbital.yaml``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from r4w_tpu_torch.core.types import resolve_device
from r4w_tpu_torch.gnss import acquisition, scenario

_MEMO: dict = {}

GATE_PRNS = (3, 25, 8, 2, 5, 16, 13, 15)   # docs/bench_records/r5_session_e1c_tracking_e1b.json
GATE_CN0_DBHZ = 34.0
GATE_RATE_HZ = 5e6                          # tests/test_gnss.py:225
GATE_SEED = 19
ABSENT_CONTROLS = (9, 30, 44)
ACQ_DOPPLER_MAX_HZ, ACQ_DOPPLER_STEP_HZ = 5000.0, 125.0
GENERATE_BLOCK = 1 << 18


def gate_config(seed: int = GATE_SEED) -> scenario.ScenarioConfig:
    """The 8-SV E1C scene: off-grid Dopplers within ±3 kHz and ranges of
    2.0-2.6·10⁷ m drawn from `seed`; each SV's range rate is the one its
    Doppler implies, so code and carrier stay consistent over the capture
    (a constant Doppler over a constant range would step the code back at
    every generated block)."""
    rng = np.random.default_rng(seed)
    dops = rng.uniform(-3000.0, 3000.0, len(GATE_PRNS))
    ranges = rng.uniform(2.0e7, 2.6e7, len(GATE_PRNS))
    sats = tuple(
        scenario.SatelliteConfig(
            signal="GalileoE1C", prn=p, cn0_dbhz=GATE_CN0_DBHZ, doppler_hz=float(d),
            range_m=float(r),
            range_rate_mps=float(-d * scenario.LIGHT_SPEED / scenario.GALILEO_E1_HZ))
        for p, d, r in zip(GATE_PRNS, dops, ranges))
    return scenario.ScenarioConfig(satellites=sats, sample_rate=GATE_RATE_HZ, seed=seed)


def samples_per_period(fs: float) -> int:
    return int(round(fs * 4092 / 1.023e6))


def e1c_waves(prns, signal: str = "GalileoE1C") -> list[np.ndarray]:
    """Each PRN's CBOC waveform at `scenario.SUBCHIP` subchips a chip."""
    return [scenario._spread_waveform(scenario.SatelliteConfig(signal=signal, prn=p))
            for p in prns]


def acquire_e1c(rx: torch.Tensor, prns, waves, fs: float, periods: int):
    """PCPS over `periods` code periods with the 4-subphase bank."""
    codes = acquisition.sampled_code_bank(
        waves, scenario.CHIP_RATE * scenario.SUBCHIP, fs, samples_per_period(fs),
        n_subphases=4)
    cfg_a = acquisition.PcpsConfig(
        doppler_max_hz=ACQ_DOPPLER_MAX_HZ, doppler_step_hz=ACQ_DOPPLER_STEP_HZ,
        threshold=1.0, coherent_periods=periods)
    return acquisition.acquire(rx, codes, prns, fs, cfg_a)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def e1c_capture(source, periods: int, device=None):
    """(cfg, rx on the device, prns, number present, waves, acquisition,
    timings) for `source` (a `ScenarioConfig` or a YAML path) over
    `periods` code periods: generated and acquired once per (source,
    periods, device) per process."""
    device = resolve_device(device)
    ident = os.path.abspath(source) if isinstance(source, str) else source
    key = (ident, int(periods), str(device))
    if key in _MEMO:
        return _MEMO[key]
    _sync(device)
    t0 = time.perf_counter()
    cfg = (scenario.load_scenario_yaml(source) if isinstance(source, str) else source)
    gen = scenario.GnssScenario(cfg, device=device)
    fs = cfg.sample_rate
    n_per = samples_per_period(fs)
    rx = gen.generate_device(periods * n_per / fs, block_size=GENERATE_BLOCK)[: periods * n_per]
    _sync(device)
    gen_s = time.perf_counter() - t0

    present = [s.prn for s in cfg.satellites]
    absent = [p for p in ABSENT_CONTROLS if p not in present][:2]
    prns = present + absent
    waves = e1c_waves(prns)
    t1 = time.perf_counter()
    acq = acquire_e1c(rx, prns, waves, fs, periods)
    _sync(device)
    acquire_s = time.perf_counter() - t1
    out = (cfg, rx, prns, len(present), waves, acq, {"gen_s": gen_s, "acquire_s": acquire_s})
    _MEMO[key] = out
    return out


def clear_memo() -> None:
    """Forget every capture (a warm run that must generate again)."""
    _MEMO.clear()
