"""GLONASS L1OF FDMA acquisition and tracking (the third constellation).

PyTorch counterpart of the JAX package's ``tools/glonass_track.py``. A
6-SV scenario puts every satellite on its own FDMA channel (k·562.5 kHz,
k = −3…+2) with the true 0.511 Mchip/s code rate, distinct range rates
and PRBS nav bits at 50 bit/s. The receiver knows only the FDMA plan: it
mixes each channel to baseband with the exact integer-phase rational (no
float drift over the capture), runs PCPS acquisition per channel with the
shared 511-chip m-sequence, hands off to the Costas DLL/PLL (all six
channels in one `tracking.track` call) and recovers the 20 ms nav bits
from the prompts. All six channels share one spreading code: the only
separation is frequency.

The capture, the mixdown bank, the acquisition and the tracking run on
one device (the CUDA card unless named); the verdicts are host numpy.
No hand-written kernel is on this path.

Run: ``python -m r4w_tpu_torch.gnss.glonass_track [--quick]`` prints one
JSON line (``--quick``: 0.3 s on the CPU, too short for the bit match).
"""

from __future__ import annotations

import json
import math
import sys
import time
from fractions import Fraction

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, real_scalar, resolve_device
from r4w_tpu_torch.gnss import acquisition, tracking
from r4w_tpu_torch.gnss import prn as prn_mod
from r4w_tpu_torch.gnss.gps_pvt_fix import _device_name, _sync
from r4w_tpu_torch.gnss.scenario import (GnssScenario, ReceiverConfig, SatelliteConfig,
                                         ScenarioConfig)

FS = 6_132_000.0          # 12 samples/chip, exact on the 562.5 kHz grid
CHIP_RATE = 511_000.0
CODE_LEN = 511
SPS = 12                  # samples per chip
L = CODE_LEN * SPS        # samples per 1 ms code period
GLONASS_L1_HZ = 1_602_000_000.0
FDMA_STEP_HZ = 562_500.0
LIGHT = 299_792_458.0
KS = (-3, -2, -1, 0, 1, 2)
RANGE_RATES_MPS = (-90.0, -55.0, -20.0, 15.0, 50.0, 85.0)
DURATION_S = 4.0
ACQ_CONFIG = acquisition.PcpsConfig(doppler_max_hz=750.0, doppler_step_hz=250.0,
                                    coherent_periods=8, threshold=2.0, subsample_phases=1)
ACQ_PERIODS = 12          # the acquisition slice, in code periods


def _fdma_plan(ks):
    """(nums (K,), den) with num/den = k·562.5 kHz / fs exactly."""
    fracs = [Fraction(k * FDMA_STEP_HZ) / Fraction(FS) for k in ks]
    den = 1
    for fr in fracs:
        den = den * fr.denominator // math.gcd(den, fr.denominator)
    return np.asarray([int(fr * den) % den for fr in fracs],
                      np.int32), den


def _prbs_bits(seed: int, n: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (1 - 2 * rng.integers(0, 2, n)).astype(np.int32)


def mixdown(x: torch.Tensor, nums, den: int) -> torch.Tensor:
    """(K, N) baseband bank: row k is x · e^{-j2π·((n mod den)·nums[k] mod
    den)/den}, the phase exact in int32 and rounded once to float32. The
    products stay below 2^31 only because den is small (checked)."""
    if (den - 1) ** 2 >= 2 ** 31:
        raise ValueError(f"FDMA denominator {den}: (n mod den)·m overflows int32")
    device = x.device
    q = torch.remainder(torch.arange(x.shape[-1], dtype=torch.int32, device=device), den)
    den_t = real_scalar(float(den), device)
    out = torch.empty((len(nums), x.shape[-1]), dtype=IQ_DTYPE, device=device)
    for i, m in enumerate(np.asarray(nums, np.int64)):
        ph = torch.remainder(q * int(m), den).to(torch.float32) / den_t
        out[i] = x * cis((-2.0 * math.pi) * ph)
    return out


def glonass_scenario(duration_s: float = DURATION_S, cn0_dbhz: float = 45.0):
    """(ScenarioConfig, nav bits per SV) of the gate: six FDMA channels
    k = −3…+2, range rates −90…+85 m/s, 256-bit PRBS nav at 50 bit/s."""
    prns = list(range(1, len(KS) + 1))
    nav = [_prbs_bits(100 + p) for p in prns]
    sats = tuple(
        SatelliteConfig(
            signal="GlonassL1of", prn=p, cn0_dbhz=cn0_dbhz,
            carrier_offset_hz=k * FDMA_STEP_HZ,
            range_m=21_000_000.0 + 150_000.0 * i,
            range_rate_mps=RANGE_RATES_MPS[i], elevation_deg=55.0,
            nav_data=True, nav_bits=tuple(int(v) for v in nav[i]))
        for i, (p, k) in enumerate(zip(prns, KS)))
    cfg = ScenarioConfig(sample_rate=FS, duration_s=duration_s,
                         satellites=sats,
                         receiver=ReceiverConfig(lat_deg=45.0,
                                                 lon_deg=7.0),
                         seed=202)
    return cfg, nav


def glonass_receiver(mixed: torch.Tensor, prns) -> dict:
    """Per-channel PCPS on the first 12 ms of each baseband row, then the
    Costas DLL/PLL over each row from its code epoch, all channels in one
    `tracking.track` call."""
    device = mixed.device
    code = prn_mod.glonass_l1of_code().astype(np.float32)
    code_os = torch.from_numpy(np.repeat(code, SPS)[None]).to(device)  # (1, L)
    n_acq = ACQ_PERIODS * L
    _sync(device)
    t1 = time.perf_counter()
    det, tau, dop, metric = [], [], [], []
    for i, p in enumerate(prns):
        res = acquisition.acquire(mixed[i, :n_acq], code_os, [p], FS, ACQ_CONFIG)
        det.append(bool(res.detected.cpu()[0]))
        tau.append(float(res.code_phase.cpu()[0]))
        dop.append(float(res.doppler_hz.cpu()[0]))
        metric.append(float(res.peak_metric.cpu()[0]))
    acquire_s = time.perf_counter() - t1
    det = np.asarray(det)
    tau = np.asarray(tau)
    dop = np.asarray(dop)

    # --- DLL/PLL per channel (code-epoch-aligned), one batched call ----
    t2 = time.perf_counter()
    tcfg = tracking.TrackingConfig(
        code_length=CODE_LEN, sample_rate=FS, chipping_rate=CHIP_RATE,
        carrier_hz=GLONASS_L1_HZ, costas=True, fll_gain=0.2)
    cps = CHIP_RATE / FS
    istart = np.floor(tau).astype(np.int64)
    frac = tau - istart
    phase0 = (CODE_LEN - frac * cps) % CODE_LEN
    bs = tcfg.block_size
    n_keep = ((mixed.shape[-1] - int(istart.max())) // bs) * bs
    rows = torch.stack([mixed[i, s: s + n_keep] for i, s in enumerate(istart)])
    st0 = tracking.init_state(tcfg, phase0.astype(np.float32), dop.astype(np.float32),
                              device=device)
    _fin, outs = tracking.track(tcfg, st0, rows, torch.from_numpy(code).to(device))
    prompt_i = outs.prompt_i.cpu().numpy().astype(np.float64)
    _sync(device)
    track_s = time.perf_counter() - t2
    return {"det": det, "tau": tau, "dop": dop, "metric": metric, "prompt_i": prompt_i,
            "prompt_q": outs.prompt_q.cpu().numpy().astype(np.float64),
            "carr_freq": outs.carrier_freq.cpu().numpy().astype(np.float64),
            "code_phase": outs.code_phase.cpu().numpy().astype(np.float64),
            "cn0": outs.cn0_dbhz.cpu().numpy().astype(np.float64),
            "acquire_s": acquire_s, "track_s": track_s}


def channel_verdicts(rcv: dict, nav) -> list[dict]:
    """Per channel: lock (mean |I| / mean |Q| over the second half),
    Doppler error against the truth range rate, C/N0, and the best 20 ms
    bit match against the transmitted PRBS over 20 bit offsets and 256
    cyclic shifts (either sign: Costas 180° ambiguity)."""
    det, metric = rcv["det"], rcv["metric"]
    prompt_i, prompt_q = rcv["prompt_i"], rcv["prompt_q"]
    carr, cn0_tr = rcv["carr_freq"], rcv["cn0"]
    n_blocks = prompt_i.shape[1]
    half = n_blocks // 2
    per_ch = []
    for i, k in enumerate(KS[:len(nav)]):
        # expected residual Doppler on THIS channel after mixdown
        f_ch = GLONASS_L1_HZ + k * FDMA_STEP_HZ
        dop_true = -RANGE_RATES_MPS[i] * f_ch / LIGHT
        dop_meas = float(np.median(carr[i, half:]))
        # I/Q power dominance over the locked half
        pi = prompt_i[i, half:]
        pq = prompt_q[i, half:]
        lock = float(np.mean(np.abs(pi)) / (np.mean(np.abs(pq)) + 1e-12))
        cn0_est = float(np.median(cn0_tr[i, -1000:]))
        # 20 ms nav bits: best (offset, shift) alignment against the
        # transmitted PRBS; Costas 180° ambiguity → accept either sign
        signs = np.sign(pi)
        best = 0.0
        for off in range(20):
            m = (len(signs) - off) // 20
            if m < 60:
                continue
            grp = signs[off:off + m * 20].reshape(m, 20).sum(axis=1)
            bits_est = np.sign(grp + 1e-9).astype(np.int32)
            tx = np.asarray(nav[i], np.float64)
            # correlate over cyclic shifts of the 256-bit PRBS
            for sh in range(256):
                ref = tx[(sh + np.arange(m)) % 256]
                match = float(np.mean(bits_est == ref))
                best = max(best, match, 1.0 - match)
        ok = bool(det[i] and lock > 2.0
                  and abs(dop_meas - dop_true) < 5.0 and best >= 0.98)
        per_ch.append({
            "prn": i + 1, "k": k, "acq": bool(det[i]),
            "acq_metric": metric[i],
            "dop_err_hz": dop_meas - dop_true,
            "lock": lock, "cn0_dbhz": cn0_est,
            "bit_match": best, "ok": ok,
        })
    return per_ch


def main(cn0_dbhz: float = 45.0, duration_s: float = DURATION_S, device=None) -> dict:
    """The GLONASS gate on `device` (default: the CUDA card): scenario →
    exact FDMA mixdown → per-channel acquisition → tracking → verdicts.
    Passes with every channel acquired, locked (> 2), within 5 Hz of its
    Doppler and at a bit match of at least 0.98."""
    device = resolve_device(device)
    cfg, nav = glonass_scenario(duration_s, cn0_dbhz)
    prns = [s.prn for s in cfg.satellites]

    _sync(device)
    t0 = time.perf_counter()
    rx = GnssScenario(cfg, device=device).generate_device(duration_s)
    _sync(device)
    gen_s = time.perf_counter() - t0

    # --- exact FDMA mixdown (one (K, N) baseband bank) ----------------
    t1 = time.perf_counter()
    nums, den = _fdma_plan(KS)
    mixed = mixdown(rx, nums, den)
    del rx
    _sync(device)
    mix_s = time.perf_counter() - t1

    rcv = glonass_receiver(mixed, prns)
    per_ch = channel_verdicts(rcv, nav)
    n_lock = sum(c["ok"] for c in per_ch)
    return {
        "metric": "glonass_track",
        "value": n_lock,
        "unit": "channels",
        "of": len(KS),
        "pass": bool(n_lock == len(KS)),
        "cn0_dbhz": cn0_dbhz,
        "fs": FS,
        "per_ch": per_ch,
        "device": _device_name(device),
        "gen_s": gen_s,
        "mix_s": mix_s,
        "acquire_s": rcv["acquire_s"],
        "track_s": rcv["track_s"],
    }


if __name__ == "__main__":
    if "--quick" in sys.argv:
        print(json.dumps(main(duration_s=0.3, device="cpu")))
    else:
        print(json.dumps(main()))
