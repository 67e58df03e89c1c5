"""Dual-constellation (GPS L1 C/A + Galileo E1B) IQ to a position fix
from one capture.

PyTorch counterpart of the JAX package's ``tools/dual_pvt.py``. One
scenario synthesizes a single IQ stream at 5.115 MS/s carrying 5 GPS
satellites (ephemeris-bearing LNAV, `gps_pvt_fix` conventions) and 5
Galileo satellites (ephemeris-bearing I/NAV words 1-5, `galileo_pvt`
conventions) over one receiver, on a shared GPS/GST time base (bit or
symbol 0 of every SV transmits at t0_sow; the simulated GGTO is zero, but
the two front ends carry different receiver-chain group delays, so the
joint solve estimates an inter-system bias state).

Both front ends run on the same samples: L1 C/A PCPS + Costas DLL/PLL
(1 ms blocks) and E1B sub-sample-bank PCPS + squared-prompt Doppler
refine + BOC code sweep + Costas DLL/PLL (4 ms blocks). The back end
decodes LNAV subframes 1-3 and I/NAV words 1-5 (the I/NAV Viterbi decodes
on the device), forms all ten transmit times from the decoded TOW, and
solves three fixes from the same observables: GPS-only, Galileo-only and
the joint 10-satellite fix with one clock state per system, plus the
velocity and clock drift from the tracked carrier Dopplers against the
decoded ephemerides' satellite velocities (the receiver is static, so the
solved speed is the end-to-end Doppler error budget).

The joint fix's GDOP is the reference's: `pvt.solve_position_multi` takes
it from the position block and the FIRST system's clock only.

Run: ``python -m r4w_tpu_torch.gnss.dual_pvt [--quick]`` prints one JSON
line (``--quick``: 0.3 s on the CPU, too short to decode).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from r4w_tpu_torch.core.types import resolve_device
from r4w_tpu_torch.gnss import galileo_pvt as gal
from r4w_tpu_torch.gnss import gps_pvt_fix as gps
from r4w_tpu_torch.gnss import nav_message as nm
from r4w_tpu_torch.gnss import pvt
from r4w_tpu_torch.gnss.coordinates import lla_to_ecef
from r4w_tpu_torch.gnss.ephemeris import circular_ephemeris_for_position
from r4w_tpu_torch.gnss.gps_pvt_fix import _device_name, _sync
from r4w_tpu_torch.gnss.scenario import (GnssScenario, ReceiverConfig, SatelliteConfig,
                                         ScenarioConfig)

FS = 5_115_000.0  # 5 samples/chip: integer per GPS ms AND E1 epoch
CHIP_RATE = 1_023_000.0
GPS_SHELL_M = 26_560e3
GAL_SHELL_M = 29_600e3
DURATION_S = 24.3
TOW_SF4 = 57_600
# Distinct per-SV range rates (=> Doppler spread): ten satellites at zero
# relative Doppler is the C/A multi-access worst case (static
# cross-correlations bias each DLL); rates stay inside the acquisition
# searches (GPS ±500 Hz, E1B ±400 Hz; 5.255 Hz per m/s at L1).
GPS_RANGE_RATES_MPS = (-90.0, -45.0, 0.0, 40.0, 85.0)
GAL_RANGE_RATES_MPS = (-70.0, -30.0, 15.0, 50.0, 75.0)
L1_WAVELENGTH_M = pvt.SPEED_OF_LIGHT / 1_575_420_000.0  # L1/E1 carrier


def _geometry(n_gps=5, n_gal=5):
    """One receiver truth; a deterministic well-conditioned sky: each
    constellation's azimuths evenly spread with the two constellations
    interleaved (Galileo offset half a slot), elevations alternating
    low/high. A random draw here once produced a one-quadrant cluster
    with GDOP 128 that turned 17 m pseudorange noise into a 1.1 km
    fix — geometry is part of the gate's spec, not luck."""
    truth = np.asarray(lla_to_ecef(45.0, 7.0, 250.0))
    up = truth / np.linalg.norm(truth)
    east = np.cross([0, 0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)

    def shell(n, radius, az0_deg, els_deg):
        out = []
        for i in range(n):
            a = np.radians(az0_deg + i * 360.0 / n)
            e = np.radians(els_deg[i % len(els_deg)])
            los = (np.cos(e) * (np.sin(a) * east + np.cos(a) * north)
                   + np.sin(e) * up)
            b = 2 * truth @ los
            c = truth @ truth - radius ** 2
            t = (-b + np.sqrt(b * b - 4 * c)) / 2
            out.append(truth + t * los)
        return np.asarray(out)

    gps_pos = shell(n_gps, GPS_SHELL_M, 0.0, [62.0, 28.0, 47.0, 25.0, 55.0])
    gal_pos = shell(n_gal, GAL_SHELL_M, 180.0 / max(n_gal, 1),
                    [33.0, 58.0, 26.0, 50.0, 40.0])
    return truth, gps_pos, gal_pos


def dual_scenario(duration_s: float = DURATION_S, cn0_dbhz: float = 48.0):
    """(ScenarioConfig, truth, GPS positions, Galileo positions, t0_sow) of
    the joint gate: ephemerides anchored near the end of the capture."""
    truth, gps_pos, gal_pos = _geometry()
    t0_sow = nm.subframe_start_sow(TOW_SF4)
    tow_w5 = t0_sow + (250 + 4 * 500) * gal.T_EP
    t_eval = t0_sow + duration_s - 0.3
    t_el_eval = t_eval - t0_sow
    gps_ephs = [circular_ephemeris_for_position(
        gps.eval_pos(gps_pos[i], truth, GPS_RANGE_RATES_MPS[i], t_el_eval), truth,
        t_eval, prn=i + 1, range_rate_mps=GPS_RANGE_RATES_MPS[i])
        for i in range(len(gps_pos))]
    gal_ephs = [circular_ephemeris_for_position(
        gps.eval_pos(gal_pos[i], truth, GAL_RANGE_RATES_MPS[i], t_el_eval), truth,
        t_eval, prn=i + 1, toe_quantum=60.0, range_rate_mps=GAL_RANGE_RATES_MPS[i])
        for i in range(len(gal_pos))]
    sats = tuple(
        SatelliteConfig(
            signal="GpsL1Ca", prn=i + 1, cn0_dbhz=cn0_dbhz, doppler_hz=0.0,
            range_m=float(np.linalg.norm(gps_pos[i] - truth)),
            range_rate_mps=GPS_RANGE_RATES_MPS[i],
            nav_data=True,
            nav_bits=tuple(int(v) for v in 1 - 2 * gps.build_sv_nav_bits(gps_ephs[i], TOW_SF4)))
        for i in range(len(gps_pos))) + tuple(
        SatelliteConfig(
            signal="GalileoE1B", prn=i + 1, cn0_dbhz=cn0_dbhz,
            doppler_hz=0.0,
            range_m=float(np.linalg.norm(gal_pos[i] - truth)),
            range_rate_mps=GAL_RANGE_RATES_MPS[i],
            nav_data=True,
            nav_bits=tuple(int(v) for v in
                           1 - 2 * gal.build_sv_nav_symbols(gal_ephs[i], i + 1, tow_w5)))
        for i in range(len(gal_pos)))
    cfg = ScenarioConfig(sample_rate=FS, duration_s=duration_s,
                         satellites=sats,
                         receiver=ReceiverConfig(lat_deg=45.0,
                                                 lon_deg=7.0),
                         seed=202)
    return cfg, truth, gps_pos, gal_pos, t0_sow


def solve_fixes(truth, cons, sat_ps, truth_ps, rhos, sat_vs, rrs) -> dict:
    """The three position fixes, the velocity and the truth-position
    control from per-SV observables (`cons` the system of each: "gps" or
    "gal"), as the reference's gate forms them."""
    cons = np.asarray(cons)

    def _solve(mask):
        if int(mask.sum()) < 4:
            return None
        sol = pvt.solve_position(sat_ps[mask], rhos[mask])
        return {
            "error_m": float(np.linalg.norm(np.asarray(sol.position_ecef) - truth)),
            "n_sats": int(mask.sum()),
            "clock_bias_m": float(sol.clock_bias_m),
            "gdop": sol.gdop,
            "max_residual_m": float(np.abs(np.asarray(sol.residuals_m)).max()),
        }

    # joint fix: 3 position states + one clock state per system — the
    # two front ends carry different receiver-chain group delays, so a
    # single shared bias would alias the inter-system offset into position
    joint = None
    velocity = None
    if len(cons) >= 5 and len(set(cons.tolist())) == 2:
        sol = pvt.solve_position_multi(sat_ps, rhos, cons.tolist())
        # the receiver is static, so the solved velocity magnitude IS the
        # end-to-end Doppler-chain error budget
        vsol = pvt.solve_velocity(sol, sat_ps, sat_vs, rrs)
        speed = float(np.linalg.norm(np.asarray(vsol.velocity_ecef)))
        velocity = {
            "speed_mps": speed,
            "clock_drift_mps": float(vsol.clock_drift_mps),
            "pass": bool(speed < 1.0),
        }
        joint = {
            "error_m": float(np.linalg.norm(np.asarray(sol.position_ecef) - truth)),
            "n_sats": len(cons),
            "gdop": sol.gdop,
            "isb_m": sol.system_biases_m["gps"] - sol.system_biases_m["gal"],
            "system_biases_m": dict(sol.system_biases_m),
            "max_residual_m": float(np.abs(np.asarray(sol.residuals_m)).max()),
        }
    elif len(cons) >= 4:
        joint = _solve(np.ones(len(cons), bool))
    gps_only = _solve(cons == "gps")
    gal_only = _solve(cons == "gal")

    # control: same rhos against TRUTH satellite positions (on the truth
    # range trajectory at each decoded t_tx) — separates decoded-ephemeris
    # position error from pseudorange error
    ctrl = None
    if len(rhos) >= 5 and len(set(cons.tolist())) == 2:
        sol = pvt.solve_position_multi(truth_ps, rhos, cons.tolist())
        ctrl = {"error_m": float(np.linalg.norm(np.asarray(sol.position_ecef) - truth)),
                "system_biases_m": dict(sol.system_biases_m)}
    return {"joint": joint, "velocity": velocity, "gps_only": gps_only,
            "galileo_only": gal_only, "truth_pos_control": ctrl}


def main(cn0_dbhz: float = 48.0, duration_s: float = DURATION_S, device=None) -> dict:
    """The joint gate on `device` (default: the CUDA card). Passes with all
    ten SVs decoded and a joint error under 60 m."""
    device = resolve_device(device)
    cfg, truth, gps_pos, gal_pos, t0_sow = dual_scenario(duration_s, cn0_dbhz)
    gps_prns = list(range(1, len(gps_pos) + 1))
    gal_prns = list(range(1, len(gal_pos) + 1))
    c = pvt.SPEED_OF_LIGHT

    _sync(device)
    t0 = time.perf_counter()
    rx = GnssScenario(cfg, device=device).generate_device(duration_s)
    _sync(device)
    gen_s = time.perf_counter() - t0

    # --- both front ends on the SAME samples ---------------------------
    gr = gps.l1ca_receiver(rx, gps_prns, fs=FS)
    er = gal.e1b_receiver(rx, gal_prns)

    # --- decode + transmit times per channel (host) --------------------
    def _truth_range(pos0, rdot, t_tx):
        return gps.range_at_tx(pos0, truth, rdot, t_tx - t0_sow)

    recs, cons, sat_ps, truth_ps, rhos = [], [], [], [], []
    sat_vs, rrs = [], []

    def _channel(front, i, sys_name, pos0, rdot, decode):
        rec, eph_dec, t_tx = decode()
        rec["sys"] = sys_name
        recs.append(rec)
        if eph_dec is None:
            return
        m = front["prompt_i"].shape[1] - 10
        t_rx = t0_sow + (front["istart"][i] + m * front["bs"]) / FS
        sat_ps.append(np.asarray(eph_dec.position(t_tx)))
        rhos.append(c * (t_rx - t_tx))
        rec["rho_err_m"] = rhos[-1] - _truth_range(pos0, rdot, t_tx)
        los = pos0 - truth
        truth_ps.append(truth + _truth_range(pos0, rdot, t_tx)
                        * los / np.linalg.norm(los))
        # velocity observables: tracked carrier Doppler (median of the
        # last ~2 s of blocks) -> geometric range rate; satellite
        # velocity from the decoded ephemeris (central difference)
        n2s = max(1, int(round(2.0 * FS / front["bs"])))  # blocks in 2 s
        dop_meas = float(np.median(front["carr_freq"][i, max(0, m - n2s):m]))
        rrs.append(-dop_meas * L1_WAVELENGTH_M)
        sat_vs.append((np.asarray(eph_dec.position(t_tx + 0.5))
                       - np.asarray(eph_dec.position(t_tx - 0.5))))
        rec["rr_err_mps"] = rrs[-1] - rdot
        cons.append(sys_name)

    t3 = time.perf_counter()
    m_g = gr["prompt_i"].shape[1] - 10
    for i, p in enumerate(gps_prns):
        _channel(gr, i, "gps", gps_pos[i], GPS_RANGE_RATES_MPS[i],
                 lambda i=i, p=p: gps.decode_sv_channel(
                     gr["prompt_i"][i], gr["code_ph"][i, :-1],
                     float(gr["phase0"][i]), m_g, p))
    m_e = er["prompt_i"].shape[1] - 10
    for i, p in enumerate(gal_prns):
        _channel(er, i, "gal", gal_pos[i], GAL_RANGE_RATES_MPS[i],
                 lambda i=i, p=p: gal.decode_sv_channel(
                     er["prompt_i"][i], er["code_ph"][i, :-1],
                     float(er["phase_ref"][i]), m_e, p,
                     er["code_len"], device))
    decode_s = time.perf_counter() - t3

    def _rows(v):
        return np.stack(v) if len(v) else np.zeros((0, 3))

    fixes = solve_fixes(truth, cons, _rows(sat_ps), _rows(truth_ps), np.asarray(rhos),
                        _rows(sat_vs), np.asarray(rrs))
    joint = fixes["joint"]
    decoded = len(cons)
    n_total = len(gps_prns) + len(gal_prns)
    err = joint["error_m"] if joint else float("inf")
    return {
        "metric": "dual_pvt_error",
        "value": err,
        "unit": "m",
        "mode": "decoded_ephemeris_joint",
        "pass": bool(decoded == n_total and joint is not None
                     and err < 60.0),
        "acquired": int(gr["det"].sum() + er["det"].sum()),
        "decoded": decoded,
        "of": n_total,
        **fixes,
        "cn0_est_gps_dbhz": gr["cn0_est"],
        "cn0_est_gal_dbhz": er["cn0_est"],
        "per_sv": recs,
        "device": _device_name(device),
        "gen_s": gen_s,
        "acquire_s": gr["acquire_s"] + er["acquire_s"],
        "track_s": gr["track_s"] + er["track_s"],
        "stage_s": {"gps_acquire_s": gr["acquire_s"], "gps_track_s": gr["track_s"],
                    "gal_acquire_s": er["acquire_s"], "gal_track_s": er["track_s"],
                    "decode_s": decode_s},
    }


if __name__ == "__main__":
    if "--quick" in sys.argv:
        print(json.dumps(main(duration_s=0.3, device="cpu")))
    else:
        print(json.dumps(main()))
