"""GPS L1 C/A receiver from IQ to a position fix.

PyTorch counterpart of the JAX package's ``tools/gps_pvt_fix.py``. Two
modes:

``main_decoded`` (the headline gate): a 6-SV scenario overlays real
ephemeris-bearing LNAV (filler SF4 + SF1-3 per SV, parity-chained,
TOW-stamped); the receiver acquires from the IQ, tracks every PRN with
the DLL/PLL, recovers 20 ms bits from the prompts, frame-syncs the LNAV
stream, decodes clock and Keplerian ephemeris from subframes 1-3, forms
transmit times from the decoded TOW, bit count and code phase, computes
satellite positions from the decoded ephemeris and solves. Nothing about
the geometry reaches the receiver except through the RF and the bits.

``main_code_phase``: acquisition-only code-phase pseudoranges with truth
integer milliseconds and truth satellite positions.

The capture, the acquisition and the tracking channels live on one
device (the CUDA card unless named); the back end (bits, frames,
ephemeris, solve) is host numpy. Stage times are wall times that end in
a device synchronisation.

Run: ``python -m r4w_tpu_torch.gnss.gps_pvt_fix [--quick]`` prints one
JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from r4w_tpu_torch.core.types import resolve_device
from r4w_tpu_torch.gnss import acquisition, pvt, tracking
from r4w_tpu_torch.gnss import nav_message as nm
from r4w_tpu_torch.gnss import prn as prn_mod
from r4w_tpu_torch.gnss.coordinates import lla_to_ecef
from r4w_tpu_torch.gnss.ephemeris import circular_ephemeris_for_position
from r4w_tpu_torch.gnss.scenario import (GnssScenario, ReceiverConfig, SatelliteConfig,
                                         ScenarioConfig)

FS = 8_184_000.0  # code-phase mode: 8 samples/chip
FS_DEC = 4_092_000.0  # decoded mode: 4 samples/chip (tracking interpolates)
CHIP_RATE = 1_023_000.0
WEEK = 200
SPEED_OF_LIGHT = 299_792_458.0
# Distinct per-SV range rates: six SVs at zero relative Doppler is the C/A
# multi-access worst case (static cross-correlations bias each DLL). The
# rates stay inside the ±500 Hz acquisition search (5.255 Hz per m/s at L1).
RANGE_RATES_MPS = (-90.0, -55.0, -20.0, 15.0, 50.0, 85.0)
TOW_SF4 = 57600  # TOW count of the filler subframe that bit 0 opens
ACQ_CONFIG = acquisition.PcpsConfig(doppler_max_hz=500.0, doppler_step_hz=250.0,
                                    coherent_periods=8, threshold=2.0)
ACQ_SECONDS = 0.012  # the acquisition slice


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def _geometry(n_sats=6, seed=0):
    """Receiver truth + satellites on a 26560 km shell at random az/el."""
    truth = np.asarray(lla_to_ecef(45.0, 7.0, 250.0))
    rng = np.random.default_rng(seed)
    up = truth / np.linalg.norm(truth)
    east = np.cross([0, 0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    sats = []
    for a, e in zip(rng.uniform(0, 2 * np.pi, n_sats),
                    rng.uniform(np.radians(25), np.radians(80), n_sats)):
        los = (np.cos(e) * (np.sin(a) * east + np.cos(a) * north)
               + np.sin(e) * up)
        b = 2 * truth @ los
        c = truth @ truth - 26_560e3 ** 2
        t = (-b + np.sqrt(b * b - 4 * c)) / 2
        sats.append(truth + t * los)
    return truth, np.asarray(sats)


def range_at_tx(pos0, truth, rdot: float, t_el_tx: float) -> float:
    """Satellite-to-receiver distance at TRANSMIT elapsed time t_el_tx
    for a moving-range scenario. The scenario synthesizes delay at
    RECEIVE time (delay(t_rx) = range(t_rx)/c, range(t) = r0 + rdot·t),
    so the distance the solver must see at transmit time satisfies
    R = r0 + rdot·(t_el_tx + R/c)."""
    r0 = float(np.linalg.norm(np.asarray(pos0) - np.asarray(truth)))
    return (r0 + rdot * t_el_tx) / (1.0 - rdot / SPEED_OF_LIGHT)


def eval_pos(pos0, truth, rdot: float, t_el_eval: float) -> np.ndarray:
    """Satellite position at the ephemeris anchor epoch on the truth
    moving-range trajectory along the fixed LOS (the static scenario
    path synthesizes range, not a 3-D track)."""
    pos0 = np.asarray(pos0)
    truth = np.asarray(truth)
    los = pos0 - truth
    r0 = np.linalg.norm(los)
    return truth + range_at_tx(pos0, truth, rdot, t_el_eval) * (los / r0)


def build_sv_nav_bits(eph, tow_count_sf4: int, week: int = WEEK) -> np.ndarray:
    """1200-bit LNAV stream: almanac-filler SF4 then SF1+SF2+SF3,
    parity-chained across all four subframes. Bit 0 transmits at
    subframe_start_sow(tow_count_sf4); the filler gives the tracking
    loops a full 6 s to pull in before the ephemeris frames start."""
    sf4 = nm.build_subframe(4, tow_count_sf4)
    eph_bits = nm.build_ephemeris_frames(
        eph, week=week, tow_count_sf1=tow_count_sf4 + 1,
        d29=int(sf4[-2]), d30=int(sf4[-1]))
    return np.concatenate([sf4, eph_bits])


def decode_sv_channel(prompt_i: np.ndarray, code_phase: np.ndarray,
                      phase0: float, m_star: int, prn: int):
    """Host-side receiver back end for one tracked channel: bit-edge
    recovery → frame sync → SF1-3 field decode → ephemeris assembly →
    transmit time at block m_star. Returns (record, eph, t_tx) with
    eph/t_tx None when the stream did not yield a full ephemeris."""
    edge = nm.find_bit_edge(prompt_i)
    bits = nm.bits_from_prompts(prompt_i, edge)
    frames = nm.frame_sync(bits)
    by_sid: dict[int, dict] = {}
    for f in frames:
        if f.subframe_id in (1, 2, 3) and f.subframe_id not in by_sid:
            by_sid[f.subframe_id] = nm.decode_subframe_fields(f.bits)
    rec = {"prn": prn, "frames": len(frames),
           "subframes": sorted(by_sid), "edge": edge}
    if not frames or len(by_sid) < 3:
        return rec, None, None
    iode_ok = (by_sid[2]["iode"] == by_sid[3]["iode"]
               == by_sid[1]["iodc"] % 256)
    rec["iode_ok"] = bool(iode_ok)
    rec["week"] = int(by_sid[1]["week"])
    eph = nm.ephemeris_from_subframes(by_sid[1], by_sid[2], by_sid[3], prn)
    cp = np.concatenate([[phase0], np.asarray(code_phase, np.float64)])
    t_tx = nm.transmit_time_at_block(m_star, frames[0], edge, lambda m: cp[m])
    # satellite clock correction (zero in this scenario, applied anyway)
    t_tx -= eph.clock_bias(t_tx)
    return rec, eph, t_tx


def ca_codes(prns) -> np.ndarray:
    """(P, 1023) ±1 float32 C/A codes."""
    return np.stack([prn_mod.gps_ca_code(p) for p in prns]).astype(np.float32)


def l1ca_receiver(rx: torch.Tensor, prns, fs: float = FS_DEC) -> dict:
    """GPS L1 C/A receiver front end on a device-resident capture: PCPS
    acquisition over a 12 ms slice (code phase and Doppler seed), then the
    Costas DLL/PLL over the whole capture, one channel per PRN, all
    channels in one `tracking.track` call with code-epoch-aligned windows:
    channel i's block m starts at sample istart_i + m·bs, so a nav-bit
    flip lands on a block edge instead of mid-block."""
    device = rx.device
    sps = int(round(fs / CHIP_RATE))
    codes = ca_codes(prns)
    codes_os = torch.from_numpy(np.repeat(codes, sps, axis=1)).to(device)
    _sync(device)
    t1 = time.perf_counter()
    res = acquisition.acquire(rx[: int(fs * ACQ_SECONDS)], codes_os, prns, fs, ACQ_CONFIG)
    det = res.detected.cpu().numpy()
    tau = res.code_phase.cpu().numpy().astype(np.float64)  # samples to chip 0
    dop = res.doppler_hz.cpu().numpy().astype(np.float64)
    acquire_s = time.perf_counter() - t1

    t2 = time.perf_counter()
    tcfg = tracking.TrackingConfig(sample_rate=fs, costas=True, fll_gain=0.2)
    cps = CHIP_RATE / fs  # chips per sample
    istart = np.floor(tau).astype(np.int64)
    frac = tau - istart
    phase0 = (1023.0 - frac * cps) % 1023.0
    st0 = tracking.init_state(tcfg, phase0.astype(np.float32), dop.astype(np.float32),
                              device=device)
    _fin, outs = tracking.track(tcfg, st0, rx, torch.from_numpy(codes).to(device),
                                start=istart)
    prompt_i = outs.prompt_i.cpu().numpy().astype(np.float64)
    _sync(device)
    track_s = time.perf_counter() - t2
    code_ph = outs.code_phase.cpu().numpy().astype(np.float64)
    cn0_est = float(np.median(outs.cn0_dbhz[:, -2000:].cpu().numpy()))
    carr_freq = outs.carrier_freq.cpu().numpy().astype(np.float64)
    return {"det": det, "istart": istart, "bs": tcfg.block_size,
            "phase0": phase0, "prompt_i": prompt_i,
            "code_ph": code_ph, "carr_freq": carr_freq,
            "cn0_est": cn0_est,
            "acquire_s": acquire_s, "track_s": track_s}


def decoded_scenario(duration_s: float = 24.3, cn0_dbhz: float = 48.0):
    """(ScenarioConfig, truth ECEF, range rates) of the decoded-ephemeris
    gate: six SVs with LNAV built from ephemerides anchored near the end of
    the capture."""
    truth, sat_pos = _geometry()
    prns = list(range(1, len(sat_pos) + 1))
    ranges = np.linalg.norm(sat_pos - truth, axis=1)
    rdots = list(RANGE_RATES_MPS[:len(prns)])
    t0_sow = nm.subframe_start_sow(TOW_SF4)  # nav bit 0 transmits here
    t_eval = t0_sow + duration_s - 0.3  # ≈ transmit epoch at m_star
    t_el_eval = t_eval - t0_sow
    ephs = [circular_ephemeris_for_position(
        eval_pos(sat_pos[i], truth, rdots[i], t_el_eval), truth,
        t_eval, prn=p, range_rate_mps=rdots[i])
        for i, p in enumerate(prns)]
    sats = tuple(
        SatelliteConfig(
            signal="GpsL1Ca", prn=p, cn0_dbhz=cn0_dbhz, doppler_hz=0.0,
            range_m=float(ranges[i]), range_rate_mps=rdots[i],
            nav_data=True,
            nav_bits=tuple(int(v) for v in 1 - 2 * build_sv_nav_bits(ephs[i], TOW_SF4)))
        for i, p in enumerate(prns))
    cfg = ScenarioConfig(sample_rate=FS_DEC, duration_s=duration_s, satellites=sats,
                         receiver=ReceiverConfig(lat_deg=45.0, lon_deg=7.0), seed=99)
    return cfg, truth, rdots


def main_decoded(duration_s: float = 24.3, cn0_dbhz: float = 48.0, device=None) -> dict:
    """The decoded-ephemeris gate on `device` (default: the CUDA card):
    scenario → acquisition → tracking → LNAV decode → PVT. Passes with
    every SV acquired and decoded and a position error under 50 m."""
    device = resolve_device(device)
    cfg, truth, rdots = decoded_scenario(duration_s, cn0_dbhz)
    prns = [s.prn for s in cfg.satellites]
    c = pvt.SPEED_OF_LIGHT
    t0_sow = nm.subframe_start_sow(TOW_SF4)

    _sync(device)
    t0 = time.perf_counter()
    rx = GnssScenario(cfg, device=device).generate_device(duration_s)
    _sync(device)
    gen_s = time.perf_counter() - t0

    rcv = l1ca_receiver(rx, prns)
    det = rcv["det"]
    istart, bs = rcv["istart"], rcv["bs"]
    phase0, prompt_i = rcv["phase0"], rcv["prompt_i"]
    code_ph, cn0_est = rcv["code_ph"], rcv["cn0_est"]

    # --- nav decode + transmit times + solve (host) ------------------
    # Block m of channel i starts at receiver sample istart_i + m·bs, so
    # each channel's pseudorange is measured at its own receiver epoch
    # t_rx_i; the solver's clock-bias state absorbs the common offset.
    n_blocks = prompt_i.shape[1]
    m_star = n_blocks - 10
    lam = c / 1_575_420_000.0  # L1 carrier wavelength
    n2s = max(1, int(round(2.0 * FS_DEC / bs)))  # blocks in 2 s
    recs, sat_ps, rhos, used = [], [], [], []
    sat_vs, rrs = [], []
    for i, p in enumerate(prns):
        rec, eph_dec, t_tx = decode_sv_channel(
            prompt_i[i], code_ph[i, :-1], float(phase0[i]), m_star, p)
        recs.append(rec)
        if eph_dec is not None:
            t_rx = t0_sow + (istart[i] + m_star * bs) / FS_DEC
            sat_ps.append(np.asarray(eph_dec.position(t_tx)))
            rhos.append(c * (t_rx - t_tx))
            # velocity observables: tracked carrier Doppler (median of the
            # last ~2 s of blocks) -> range rate; satellite velocity from
            # the decoded ephemeris (central difference)
            dop = float(np.median(rcv["carr_freq"][i, max(0, m_star - n2s):m_star]))
            rrs.append(-dop * lam)
            sat_vs.append(np.asarray(eph_dec.position(t_tx + 0.5))
                          - np.asarray(eph_dec.position(t_tx - 0.5)))
            rec["rr_err_mps"] = rrs[-1] - rdots[i]
            used.append(i)
    decoded = len(used)
    velocity = None
    if decoded >= 4:
        sol = pvt.solve_position(np.stack(sat_ps), np.asarray(rhos))
        err = float(np.linalg.norm(np.asarray(sol.position_ecef) - truth))
        clock_bias = float(sol.clock_bias_m)
        max_resid = float(np.abs(np.asarray(sol.residuals_m)).max())
        # the receiver is static, so the solved speed is the end-to-end
        # Doppler-chain error budget
        vsol = pvt.solve_velocity(sol, np.stack(sat_ps), np.stack(sat_vs), np.asarray(rrs))
        speed = float(np.linalg.norm(np.asarray(vsol.velocity_ecef)))
        velocity = {
            "speed_mps": speed,
            "clock_drift_mps": float(vsol.clock_drift_mps),
            "pass": bool(speed < 1.0),
        }
    else:
        err, clock_bias, max_resid = float("inf"), 0.0, float("inf")
    return {
        "metric": "gps_pvt_error",
        "value": err,
        "unit": "m",
        "mode": "decoded_ephemeris",
        "pass": bool(det.all() and decoded == len(prns) and err < 50.0),
        "acquired": int(det.sum()),
        "decoded": decoded,
        "of": len(prns),
        "clock_bias_m": clock_bias,
        "max_residual_m": max_resid,
        "velocity": velocity,
        "cn0_est_dbhz": cn0_est,
        "per_sv": recs,
        "device": _device_name(device),
        "gen_s": gen_s,
        "acquire_s": rcv["acquire_s"],
        "track_s": rcv["track_s"],
    }


def code_phase_scenario(duration_s: float = 0.01, cn0_dbhz: float = 48.0):
    """(ScenarioConfig, truth ECEF, satellite ECEF) of the code-phase gate:
    six static SVs at 8.184 MS/s."""
    truth, sat_pos = _geometry()
    ranges = np.linalg.norm(sat_pos - truth, axis=1)
    cfg = ScenarioConfig(
        sample_rate=FS, duration_s=duration_s,
        satellites=tuple(
            SatelliteConfig(signal="GpsL1Ca", prn=i + 1, cn0_dbhz=cn0_dbhz,
                            doppler_hz=0.0, range_m=float(r))
            for i, r in enumerate(ranges)),
        receiver=ReceiverConfig(lat_deg=45.0, lon_deg=7.0),
        seed=99)
    return cfg, truth, sat_pos


def main_code_phase(duration_s: float = 0.01, cn0_dbhz: float = 48.0, device=None,
                    iq=None) -> dict:
    """Acquisition-only gate on `device` (default: the CUDA card): truth
    satellite positions and truth integer milliseconds; measures
    code-phase ranging quality. `iq` replaces the generated capture (any
    (N,) complex samples at 8.184 MS/s, e.g. another generator's)."""
    device = resolve_device(device)
    cfg, truth, sat_pos = code_phase_scenario(duration_s, cn0_dbhz)
    ranges = np.linalg.norm(sat_pos - truth, axis=1)
    prns = [s.prn for s in cfg.satellites]
    c = pvt.SPEED_OF_LIGHT

    _sync(device)
    t0 = time.perf_counter()
    if iq is None:
        rx = GnssScenario(cfg, device=device).generate_device(duration_s)
    else:
        rx = torch.as_tensor(np.asarray(iq), dtype=torch.complex64, device=device)
    _sync(device)
    gen_s = time.perf_counter() - t0

    sps = int(round(FS / CHIP_RATE))
    codes = torch.from_numpy(np.repeat(ca_codes(prns), sps, axis=1)).to(device)
    t1 = time.perf_counter()
    res = acquisition.acquire(rx, codes, prns, FS, ACQ_CONFIG)
    det = res.detected.cpu().numpy()
    phase_samples = res.code_phase.cpu().numpy().astype(np.float64)
    acquire_s = time.perf_counter() - t1

    delay_chips = (phase_samples / sps) % 1023.0
    int_ms = np.floor(ranges / c * 1e3)
    rho = pvt.pseudoranges_from_code_phase(delay_chips, CHIP_RATE, int_ms)
    sol = pvt.solve_position(sat_pos, np.asarray(rho))
    err = float(np.linalg.norm(np.asarray(sol.position_ecef) - truth))
    return {
        "metric": "gps_pvt_error",
        "value": err,
        "unit": "m",
        "mode": "code_phase",
        "pass": bool(det.all() and err < 50.0),
        "acquired": int(det.sum()),
        "of": len(prns),
        "code_phase": phase_samples.tolist(),
        "doppler_hz": res.doppler_hz.cpu().numpy().astype(np.float64).tolist(),
        "clock_bias_m": float(sol.clock_bias_m),
        "max_residual_m": float(np.abs(np.asarray(sol.residuals_m)).max()),
        "device": _device_name(device),
        "gen_s": gen_s,
        "acquire_s": acquire_s,
    }


if __name__ == "__main__":
    if "--quick" in sys.argv:
        print(json.dumps(main_code_phase()))
    else:
        print(json.dumps(main_decoded()))
