"""Galileo E1B receiver from IQ to a position fix (signal-only).

PyTorch counterpart of the JAX package's ``tools/galileo_pvt.py``, the
Galileo twin of `gps_pvt_fix`: a 6-SV scenario overlays real I/NAV pages
on the E1B data channels (word types 1-4 carry a Keplerian ephemeris
whose decoded position reproduces each configured SV, word 5 carries GST
WN/TOW; `inav_words`) behind one filler part, so that the loops settle
before the first ephemeris page. The receiver acquires every PRN from the
IQ (PCPS with a sub-sample CBOC bank), refines Doppler with a
squared-prompt FFT over open-loop epochs, pre-aligns the code with a
±6-subchip non-coherent sweep (BOC side-peak guard), closes the Costas
DLL/PLL (E1B symbols flip per 4 ms epoch), decodes I/NAV pages from the
prompt signs (sync, deinterleave, inverted-G2 Viterbi on the device,
CRC-24Q), assembles the ephemeris from words 1-4 (IODnav checked), forms
full transmit times from the decoded word-5 TOW and the code phase
(`inav.transmit_time_at_block`, no supplied milliseconds), and solves.

One symbol per code epoch: block index is symbol index, with no bit-edge
search. The capture, the acquisition, the tracking channels and the
Viterbi decodes run on one device (the CUDA card unless named); the
Doppler refine's FFT and the back end (words, ephemeris, solve) are host
numpy, as in the reference. Stage times are wall times that end in a
device synchronisation.

Run: ``python -m r4w_tpu_torch.gnss.galileo_pvt [--quick]`` prints one
JSON line (``--quick``: 0.4 s on the CPU, too short to decode).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from r4w_tpu_torch.core.types import resolve_device
from r4w_tpu_torch.gnss import acquisition, inav, inav_words, pvt, tracking
from r4w_tpu_torch.gnss import scenario as sc
from r4w_tpu_torch.gnss.coordinates import lla_to_ecef
from r4w_tpu_torch.gnss.ephemeris import circular_ephemeris_for_position
from r4w_tpu_torch.gnss.gps_pvt_fix import _device_name, _sync
from r4w_tpu_torch.gnss.scenario import (GnssScenario, ReceiverConfig, SatelliteConfig,
                                         ScenarioConfig)

FS = 5_115_000.0          # 5 samples/chip → 20460 samples per epoch
CHIP_RATE = 1_023_000.0
T_EP = 4092 / CHIP_RATE   # 4 ms code epoch = one E1B symbol
WN = 1100
GAL_SHELL_M = 29_600e3    # Galileo orbit radius (a ≈ 29 600 km)
T0_SOW = 345_600.0        # symbol 0 transmits here; word-5 pages start 9 s later
DURATION_S = 11.2
ACQ_CONFIG = acquisition.PcpsConfig(doppler_max_hz=400.0, doppler_step_hz=50.0,
                                    threshold=1.5, coherent_periods=8)
ACQ_EPOCHS = 12           # the acquisition slice, in code epochs
REFINE_EPOCHS = 64        # open-loop epochs of the squared-prompt Doppler refine
REFINE_NFFT = 2048
SWEEP_OFFSETS = np.arange(-6.0, 7.0)  # subchips of the code sweep
SWEEP_EPOCHS = 32         # open-loop epochs per sweep offset
CN0_TAIL = 500            # closed blocks of the C/N0 estimate
CODE_LEN = 4092 * sc.SUBCHIP  # subchips of the CBOC waveform
OPEN_LOOP = dict(dll_bandwidth=0.0, pll_bandwidth=0.0, fll_gain=0.0)
CLOSED_LOOP = dict(dll_bandwidth=1.0, pll_bandwidth=10.0, fll_gain=0.0, costas=True)


def _geometry(n_sats=6, seed=1):
    """Receiver truth + satellites on the Galileo shell at random
    az/el (the gps_pvt_fix construction, Galileo radius)."""
    truth = np.asarray(lla_to_ecef(45.0, 7.0, 250.0))
    rng = np.random.default_rng(seed)
    up = truth / np.linalg.norm(truth)
    east = np.cross([0, 0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    sats = []
    for a, e in zip(rng.uniform(0, 2 * np.pi, n_sats),
                    rng.uniform(np.radians(25), np.radians(80),
                                n_sats)):
        los = (np.cos(e) * (np.sin(a) * east + np.cos(a) * north)
               + np.sin(e) * up)
        b = 2 * truth @ los
        c = truth @ truth - GAL_SHELL_M ** 2
        t = (-b + np.sqrt(b * b - 4 * c)) / 2
        sats.append(truth + t * los)
    return truth, np.asarray(sats)


def build_sv_nav_symbols(eph, prn: int, tow_word5: float) -> np.ndarray:
    """One SV's E1B symbol stream: a 250-symbol filler part (loop
    settle + odd grid offset exercise) then the five nominal pages for
    words 1-5. Symbol 0 transmits at tow_page1 − 1.0 s; word 5's page
    starts at symbol 250 + 4·500, transmitting at tow_word5."""
    words = inav_words.words_for_ephemeris(
        eph, iodnav=prn, svid=prn, wn=WN, tow_word5=tow_word5)
    rng = np.random.default_rng(1000 + prn)
    filler = rng.integers(0, 2, 250).astype(np.int32)
    pages = [inav.encode_page(d112, d16) for d112, d16 in words]
    return np.concatenate([filler] + pages)


def decode_sv_channel(prompt_i: np.ndarray, code_phase: np.ndarray,
                      phase0: float, m_star: int, prn: int,
                      code_len: float, device=None):
    """Host back end for one tracked channel: page sync + decode (the
    Viterbi decode of every page part in one call on `device`, default
    the CUDA card) → word collection → ephemeris assembly (IODnav-checked)
    → transmit time at block m_star from decoded word-5 TOW. Returns
    (record, eph, t_tx); eph/t_tx None without words 1-5."""
    soft = np.sign(np.asarray(prompt_i, np.float64))
    pages = inav.decode_stream(soft, device)
    words: dict[int, dict] = {}
    w5_page = None
    for g in pages:
        if not g["crc_ok"]:
            continue
        w = inav_words.decode_word(g["data112"], g["data16"])
        if w["type"] not in words:
            words[w["type"]] = w
            if w["type"] == 5:
                w5_page = g
    rec = {"prn": prn, "pages_crc_ok": sum(g["crc_ok"] for g in pages),
           "pages_seen": len(pages), "words": sorted(words)}
    if not ({1, 2, 3, 4, 5} <= set(words)) or w5_page is None:
        return rec, None, None
    try:
        eph = inav_words.ephemeris_from_words(words, prn)
    except ValueError as e:
        rec["iodnav_error"] = str(e)
        return rec, None, None
    rec["iodnav"] = int(words[1]["iodnav"])
    rec["wn"] = int(words[5]["wn"])
    cp = np.concatenate([[phase0], np.asarray(code_phase, np.float64)])
    t_tx = inav.transmit_time_at_block(
        m_star, w5_page["sym_index"], words[5]["tow"],
        lambda m: cp[m], code_len, T_EP)
    t_tx -= eph.clock_bias(t_tx)  # unconditional receiver hygiene
    return rec, eph, t_tx


def e1b_codes(prns) -> list[np.ndarray]:
    """Each PRN's E1B CBOC waveform, 4092 × `scenario.SUBCHIP` subchips."""
    return [sc._spread_waveform(SatelliteConfig(signal="GalileoE1B", prn=p)) for p in prns]


def tracking_config(loop: dict) -> tracking.TrackingConfig:
    """E1B tracking at FS: one 4 ms code epoch a block, the CBOC waveform
    as the code, early and late ±1 subchip; `loop` sets the bandwidths
    (`OPEN_LOOP` or `CLOSED_LOOP`)."""
    return tracking.TrackingConfig(code_length=CODE_LEN, sample_rate=FS,
                                   chipping_rate=CHIP_RATE * sc.SUBCHIP, el_spacing=2.0,
                                   block_period=T_EP, carrier_hz=sc.GALILEO_E1_HZ, **loop)


def closed_pass(rx: torch.Tensor, code_t: torch.Tensor, istart, phase_ref, dop_ref):
    """The closed Costas DLL/PLL (E1B symbols flip per epoch) from the
    refined seeds over the whole capture, channel i from sample istart_i,
    all channels in one `tracking.track` call: its TrackingOutput."""
    tcfg = tracking_config(CLOSED_LOOP)
    st0 = tracking.init_state(tcfg, np.asarray(phase_ref).astype(np.float32),
                              np.asarray(dop_ref).astype(np.float32), device=rx.device)
    return tracking.track(tcfg, st0, rx, code_t, start=istart)[1]


def _windows(rx: torch.Tensor, istart: np.ndarray, n: int):
    """(samples, start) for `tracking.track` so that channel i's blocks read
    rx[start_i : start_i + n]. The reference cuts these windows with
    ``lax.dynamic_slice``, which moves a start back so that the window
    fits; the same clamp here."""
    start = np.minimum(istart, rx.shape[0] - n)
    return rx[: int(start.max()) + n], start


def e1b_receiver(rx: torch.Tensor, prns) -> dict:
    """Galileo E1B receiver front end on a device-resident capture at
    FS: PCPS acquisition (sub-sample CBOC bank) → open-loop Doppler
    refine (squared-prompt FFT on the host: the data channel precludes
    the E1C gate's coherent CS25 trick, but at the gate C/N0 the squaring
    loss is negligible) → non-coherent ±6-subchip code sweep (BOC
    side-peak guard) → closed Costas DLL/PLL over the full capture, all
    channels in one `tracking.track` call. Shared by the Galileo-only
    gate and `dual_pvt`."""
    device = rx.device
    code_len = CODE_LEN
    n_per = int(round(FS * T_EP))
    waves = e1b_codes(prns)
    _sync(device)
    t1 = time.perf_counter()
    codes = acquisition.sampled_code_bank(
        waves, CHIP_RATE * sc.SUBCHIP, FS, n_per, n_subphases=4)
    acq = acquisition.acquire(rx[: ACQ_EPOCHS * n_per], codes, prns, FS, ACQ_CONFIG)
    det = acq.detected.cpu().numpy()
    tau = acq.code_phase.cpu().numpy().astype(np.float64)
    dop = acq.doppler_hz.cpu().numpy().astype(np.float64)
    acquire_s = time.perf_counter() - t1

    # --- open-loop refine: Doppler (squared-prompt FFT) + code sweep --
    t2 = time.perf_counter()
    scps = CHIP_RATE * sc.SUBCHIP / FS
    istart = np.floor(tau).astype(np.int64)
    frac = tau - istart
    phase0 = (code_len - frac * scps) % code_len

    cfg_open = tracking_config(OPEN_LOOP)
    bs = cfg_open.block_size
    code_t = torch.from_numpy(np.stack([np.asarray(w, np.float32) for w in waves])).to(device)

    def open_pass(ph0v, dopv, n_ep):
        s0 = tracking.init_state(cfg_open, ph0v.astype(np.float32),
                                 dopv.astype(np.float32), device=device)
        samples, start = _windows(rx, istart, n_ep * bs)
        _, o = tracking.track(cfg_open, s0, samples, code_t, start=start)
        return o.prompt_i.cpu().numpy() + 1j * o.prompt_q.cpu().numpy()

    # squared-prompt Doppler: residual ≤ ±25 Hz (50 Hz grid) doubles
    # to ≤ ±50 Hz, safely inside the ±125 Hz squared-stream Nyquist
    p_o = open_pass(phase0, dop, REFINE_EPOCHS)
    nfft = REFINE_NFFT
    z = np.abs(np.fft.fft(p_o * p_o, nfft, axis=1))
    pk = np.argmax(z, axis=1)
    rows = np.arange(len(prns))
    s_m = z[rows, (pk - 1) % nfft]
    s_p = z[rows, (pk + 1) % nfft]
    s_0 = z[rows, pk]
    den = s_m - 2 * s_0 + s_p
    delta = np.clip(0.5 * (s_m - s_p)
                    / np.where(np.abs(den) < 1e-30, -1e-30, den),
                    -0.5, 0.5)
    bins = np.where(pk > nfft // 2, pk - nfft, pk) + delta
    dop_ref = dop + bins / (2.0 * nfft * T_EP)  # /2: squared stream

    # non-coherent ±6-subchip code sweep (BOC side-peak guard +
    # PCPS handover error, the e1c_tracking stage-0 pattern)
    cand = SWEEP_OFFSETS
    mets = np.stack([
        np.mean(np.abs(open_pass((phase0 + off) % code_len, dop_ref,
                                 SWEEP_EPOCHS)) ** 2, axis=1)
        for off in cand])
    k0 = np.clip(np.argmax(mets, axis=0), 1, len(cand) - 2)
    pm, p0_, pp = mets[k0 - 1, rows], mets[k0, rows], mets[k0 + 1, rows]
    den = pm - 2 * p0_ + pp
    d0 = np.clip(0.5 * (pm - pp)
                 / np.where(np.abs(den) < 1e-30, -1e-30, den),
                 -0.5, 0.5)
    phase_ref = (phase0 + cand[k0] + d0) % code_len

    # --- closed DLL/PLL over the full capture (Costas: data channel) --
    outs = closed_pass(rx, code_t, istart, phase_ref, dop_ref)
    prompt_i = outs.prompt_i.cpu().numpy().astype(np.float64)
    _sync(device)
    track_s = time.perf_counter() - t2
    code_ph = outs.code_phase.cpu().numpy().astype(np.float64)
    cn0_est = float(np.median(outs.cn0_dbhz[:, -CN0_TAIL:].cpu().numpy()))
    carr_freq = outs.carrier_freq.cpu().numpy().astype(np.float64)
    return {"det": det, "istart": istart, "bs": bs,
            "code_len": code_len, "phase0": phase0, "dop": dop,
            "dop_ref": dop_ref, "phase_ref": phase_ref,
            "prompt_i": prompt_i, "code_ph": code_ph,
            "carr_freq": carr_freq, "cn0_est": cn0_est,
            "acquire_s": acquire_s, "track_s": track_s}


def galileo_scenario(duration_s: float = DURATION_S, cn0_dbhz: float = 48.0):
    """(ScenarioConfig, truth ECEF) of the decoded-ephemeris gate: six
    static SVs with I/NAV built from ephemerides anchored near the end of
    an 11.2 s capture (the anchor does not move with `duration_s`)."""
    truth, sat_pos = _geometry()
    prns = list(range(1, len(sat_pos) + 1))
    ranges = np.linalg.norm(sat_pos - truth, axis=1)
    tow_w5 = T0_SOW + (250 + 4 * 500) * T_EP
    t_eval = T0_SOW + DURATION_S - 0.3  # ≈ transmit epoch at m_star
    ephs = [circular_ephemeris_for_position(
        sat_pos[i], truth, t_eval, prn=p, toe_quantum=60.0)
        for i, p in enumerate(prns)]
    sats = tuple(
        SatelliteConfig(
            signal="GalileoE1B", prn=p, cn0_dbhz=cn0_dbhz,
            doppler_hz=0.0, range_m=float(ranges[i]), nav_data=True,
            nav_bits=tuple(int(v) for v in
                           1 - 2 * build_sv_nav_symbols(
                               ephs[i], p, tow_w5)))
        for i, p in enumerate(prns))
    cfg = ScenarioConfig(sample_rate=FS, duration_s=duration_s,
                         satellites=sats,
                         receiver=ReceiverConfig(lat_deg=45.0,
                                                 lon_deg=7.0),
                         seed=101)
    return cfg, truth


def main(cn0_dbhz: float = 48.0, device=None, duration_s: float = DURATION_S) -> dict:
    """The decoded-ephemeris gate on `device` (default: the CUDA card):
    scenario → acquisition → refine → tracking → I/NAV decode → PVT.
    Passes with every SV acquired and decoded and an error under 60 m."""
    device = resolve_device(device)
    cfg, truth = galileo_scenario(duration_s, cn0_dbhz)
    prns = [s.prn for s in cfg.satellites]
    c = pvt.SPEED_OF_LIGHT

    _sync(device)
    t0 = time.perf_counter()
    rx = GnssScenario(cfg, device=device).generate_device(duration_s)
    _sync(device)
    gen_s = time.perf_counter() - t0

    rcv = e1b_receiver(rx, prns)
    det = rcv["det"]
    istart, bs, code_len = rcv["istart"], rcv["bs"], rcv["code_len"]
    phase_ref, prompt_i = rcv["phase_ref"], rcv["prompt_i"]
    code_ph = rcv["code_ph"]
    # --- nav decode + transmit times + solve (host) ------------------
    n_blocks = prompt_i.shape[1]
    m_star = n_blocks - 10
    recs, sat_ps, rhos, used = [], [], [], []
    t3 = time.perf_counter()
    for i, p in enumerate(prns):
        rec, eph_dec, t_tx = decode_sv_channel(
            prompt_i[i], code_ph[i, :-1], float(phase_ref[i]), m_star,
            p, code_len, device)
        recs.append(rec)
        if eph_dec is not None:
            t_rx = T0_SOW + (istart[i] + m_star * bs) / FS
            sat_ps.append(np.asarray(eph_dec.position(t_tx)))
            rhos.append(c * (t_rx - t_tx))
            used.append(i)
    decode_s = time.perf_counter() - t3
    decoded = len(used)
    if decoded >= 4:
        sol = pvt.solve_position(np.stack(sat_ps), np.asarray(rhos))
        err = float(np.linalg.norm(np.asarray(sol.position_ecef)
                                   - truth))
        clock_bias = float(sol.clock_bias_m)
        max_resid = float(np.abs(np.asarray(sol.residuals_m)).max())
    else:
        err, clock_bias, max_resid = float("inf"), 0.0, float("inf")
    return {
        "metric": "galileo_pvt_error",
        "value": err,
        "unit": "m",
        "mode": "decoded_ephemeris",
        "pass": bool(det.all() and decoded == len(prns)
                     and err < 60.0),
        "acquired": int(det.sum()),
        "decoded": decoded,
        "of": len(prns),
        "clock_bias_m": clock_bias,
        "max_residual_m": max_resid,
        "cn0_est_dbhz": rcv["cn0_est"],
        "per_sv": recs,
        "device": _device_name(device),
        "gen_s": gen_s,
        "acquire_s": rcv["acquire_s"],
        "track_s": rcv["track_s"],
        "decode_s": decode_s,
    }


if __name__ == "__main__":
    if "--quick" in sys.argv:
        print(json.dumps(main(device="cpu", duration_s=0.4)))
    else:
        print(json.dumps(main()))
