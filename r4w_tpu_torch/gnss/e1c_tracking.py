"""Galileo E1C acquisition → tracking handoff, and E1B I/NAV off the pilot loop.

PyTorch counterpart of the JAX package's ``tools/e1c_tracking.py``. One
tracking channel per acquired PRN is seeded from PCPS acquisition and
refined in the reference's stages, then closed as an overlay-wiped pilot:

  0. a non-coherent ±6-subchip code sweep at the handover Doppler;
  1. two rounds of a joint coherent search over the 25 CS25 secondary-code
     shifts × a 1024-point FFT across epochs of open-loop prompts
     (dominance, parabolic bin interpolation), each followed by a coherent
     overlay-wiped ±6-subchip code sweep (parabolic, resolves the BOC side
     peaks);
  2. a carrier-phase seed from the wiped coherent sum of the first epochs;
  3. the pilot pass: the CS25 signs wiped from the input, 16 ms blocks,
     the full-quadrant discriminator;
  4. optionally a long dual pass whose E1B sub-prompts ride the pilot's
     NCO (`tracking.track(..., aux_code=, aux_per_block=4)`), the I/NAV
     receiver's symbol stream.

Device work is `tracking.track` on one capture read by per-channel start
indices (the reference's ``dynamic_slice`` windows, clamped as it clamps
them); the 13 code offsets of a sweep run as 13·P lanes of one call. The
input wipe multiplies each block's 4 ms spans inside the loop
(`tracking.track(wipe=)`), so no (P, N) copy of the capture is made. The
searches, fits and verdicts are the reference's numpy on the host,
expression for expression, with its ``np.clip`` and 1e-30 guards.

Run: ``python -m r4w_tpu_torch.gnss.e1c_tracking [periods]`` prints the
8-SV gate's JSON line (the scene `e1c_common.gate_config()`), on the
CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from r4w_tpu_torch.core.types import resolve_device
from r4w_tpu_torch.gnss import acquisition, e1c_common, inav, tracking
from r4w_tpu_torch.gnss import scenario as sc

CAND = np.arange(-6.0, 7.0)   # subchips of each code sweep
NFFT = 1024                   # the joint search's FFT across epochs
PILOT_EPOCHS = 4              # epochs (4 ms) per pilot-pass block
SEC_DOM_MIN, LOCK_MIN = 1.3, 0.5
CN0_WINDOW_DB = (-6.0, 15.0)  # tracked C/N0 − acquisition's, exclusive


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _windows(rx: torch.Tensor, istart: np.ndarray, n: int):
    """(samples, start) so that channel i's blocks read rx[start_i :
    start_i + n]: the reference's ``lax.dynamic_slice`` moves a start back
    until the window fits."""
    start = np.minimum(istart, rx.shape[0] - n)
    return rx[: int(start.max()) + n], start


def _parabola(m_minus, m_0, m_plus):
    """The reference's parabolic peak offset, clipped to ±0.5."""
    den = m_minus - 2 * m_0 + m_plus  # negative at a true peak
    return np.clip(0.5 * (m_minus - m_plus)
                   / np.where(np.abs(den) < 1e-30, -1e-30, den), -0.5, 0.5)


def _prompts(out: tracking.TrackingOutput) -> np.ndarray:
    """The per-block complex prompts, read to the host in one copy."""
    pq = torch.stack((out.prompt_i, out.prompt_q)).cpu().numpy()
    return pq[0] + 1j * pq[1]


def track_channels(rx, fs, prns, waves, acq, periods, cn0_cfg_dbhz=34.0, e1b_waves=None,
                   n_long=None, stages: dict | None = None):
    """Seed one tracking channel per PRN from `acq` and run all of them
    over the capture `rx` (a tensor; the channels run on its device).
    Returns (per-PRN dicts, track seconds), and the E1B per-epoch prompts
    (P, n4) un-wiped of the CS25 input wipe as a third item when
    `e1b_waves` and `n_long` are given. `stages`, if given, receives each
    stage's seconds (device-synchronised)."""
    device = rx.device
    code_len = 4092 * sc.SUBCHIP
    common = dict(code_length=code_len, sample_rate=fs,
                  chipping_rate=sc.CHIP_RATE * sc.SUBCHIP, el_spacing=2.0,
                  carrier_hz=sc.GALILEO_E1_HZ)
    cfg_open = tracking.TrackingConfig(dll_bandwidth=0.0, pll_bandwidth=0.0, fll_gain=0.0,
                                       block_period=4092 / sc.CHIP_RATE, costas=True, **common)
    scps = cfg_open.chipping_rate / fs  # subchips per sample (nominal)
    tau = acq.code_phase.cpu().numpy().astype(np.float64)  # samples to chip 0
    dop = acq.doppler_hz.cpu().numpy().astype(np.float64)
    # each channel's windows start at its code-epoch boundary (floor(tau));
    # the sub-sample remainder rides in the initial code phase
    istart = np.floor(tau).astype(np.int64)
    frac = tau - istart
    phase0 = (code_len - frac * scps) % code_len
    n_ch = len(prns)
    codes = torch.from_numpy(np.stack([np.asarray(w, np.float32) for w in waves])).to(device)
    bs = cfg_open.block_size
    n_blocks = periods - 1  # one epoch sacrificed to alignment
    n_keep = n_blocks * bs
    t_blk = cfg_open.block_period
    samples_open, start_open = _windows(rx, istart, n_keep)
    stage_s = {} if stages is None else stages

    def open_pass(ph0v, dopv):
        """Open-loop prompts (M, P, B) for code phases (M, P) (or (P,)) at
        Dopplers (P,): the M offsets of a sweep as M·P lanes of one call."""
        ph = np.atleast_2d(ph0v)
        m = ph.shape[0]
        s0 = tracking.init_state(cfg_open, ph.reshape(-1).astype(np.float32),
                                 np.tile(dopv, m).astype(np.float32), device=device)
        _, o = tracking.track(cfg_open, s0, samples_open, codes.repeat(m, 1),
                              start=np.tile(start_open, m))
        p = _prompts(o)
        return p.reshape(m, n_ch, -1) if np.ndim(ph0v) == 2 else p

    def mark(name, t):
        _sync(device)
        now = time.perf_counter()
        stage_s[name] = stage_s.get(name, 0.0) + now - t
        return now

    t0 = t = time.perf_counter()
    dop_cur = dop.copy()
    phase_cur = phase0.copy()
    rows = np.arange(n_ch)
    # stage 0: non-coherent code alignment at the handover Doppler
    mets0 = np.mean(np.abs(open_pass((phase_cur[None, :] + CAND[:, None]) % code_len,
                                     dop_cur)) ** 2, axis=2)  # (13, P)
    k0 = np.clip(np.argmax(mets0, axis=0), 1, len(CAND) - 2)
    d0 = _parabola(mets0[k0 - 1, rows], mets0[k0, rows], mets0[k0 + 1, rows])
    phase_cur = (phase_cur + CAND[k0] + d0) % code_len
    t = mark("sweep0", t)

    shifts = None
    for _round in range(2):
        # joint coherent search: 25 CS25 shifts × Doppler FFT bins
        p_a = open_pass(phase_cur, dop_cur)
        b_ep = p_a.shape[1]
        if shifts is None:
            shifts = np.stack([sc.E1C_SECONDARY[(np.arange(b_ep) + s) % 25]
                               for s in range(25)])  # (25, B)
        z = np.abs(np.fft.fft(p_a[:, None, :] * shifts[None, :, :], NFFT, axis=2))
        flat = z.reshape(z.shape[0], -1)
        idx = np.argmax(flat, axis=1)
        s_star = (idx // NFFT).astype(np.int64)
        pk = idx % NFFT
        # dominance: the winning shift's peak over every other shift's best
        per_shift = z.max(axis=2)  # (P, 25)
        best_pk = per_shift[rows, s_star].copy()
        per_shift[rows, s_star] = 0.0
        sec_dom = best_pk / np.maximum(per_shift.max(axis=1), 1e-30)
        row = z[rows, s_star]  # (P, NFFT)
        delta = _parabola(row[rows, (pk - 1) % NFFT], row[rows, pk], row[rows, (pk + 1) % NFFT])
        bins = np.where(pk > NFFT // 2, pk - NFFT, pk) + delta
        dop_cur = dop_cur + bins / (NFFT * t_blk)  # nothing was squared
        signs_b = np.stack([shifts[s_star[i]] for i in rows])  # (P, B)
        t = mark("joint_search", t)

        # coherent overlay-wiped ±6-subchip code sweep at the new Doppler
        p_o = open_pass((phase_cur[None, :] + CAND[:, None]) % code_len, dop_cur)
        mets = np.abs(np.sum(p_o * signs_b[None], axis=2))  # (13, P)
        k = np.clip(np.argmax(mets, axis=0), 1, len(CAND) - 2)
        delta = _parabola(mets[k - 1, rows], mets[k, rows], mets[k + 1, rows])
        jump = CAND[k] + delta
        phase_cur = (phase_cur + jump) % code_len
        t = mark("code_sweep", t)

    dop_ref = dop_cur
    phase0_ref = phase_cur
    dop_resid = dop_ref - dop
    jump = (phase_cur - phase0 + code_len / 2) % code_len - code_len / 2

    # carrier-phase seed: the wiped coherent sum of the first epochs
    p_c = open_pass(phase0_ref, dop_ref)
    w_c = p_c * signs_b
    ph_w = np.angle(w_c[:, :5].sum(axis=1)) / (2.0 * np.pi)
    t = mark("carrier_seed", t)

    # pilot pass: CS25 wiped from the input, 16 ms blocks, full quadrant
    n3 = (n_blocks // PILOT_EPOCHS) * PILOT_EPOCHS
    signs_full = signs_b[:, :n3].astype(np.float32)
    cfg_w = tracking.TrackingConfig(dll_bandwidth=1.0, pll_bandwidth=4.0, fll_gain=0.0,
                                    block_period=PILOT_EPOCHS * t_blk, costas=False, **common)

    def pilot_state():
        st = tracking.init_state(cfg_w, phase0_ref.astype(np.float32),
                                 dop_ref.astype(np.float32), device=device)
        return st._replace(carrier_phase=torch.from_numpy(ph_w.astype(np.float32)).to(device))

    samples_w, start_w = _windows(rx, istart, n3 * bs)
    _, outw = tracking.track(cfg_w, pilot_state(), samples_w, codes, start=start_w,
                             wipe=signs_full.reshape(n_ch, -1, PILOT_EPOCHS))
    pe_all = _prompts(outw)  # (P, n3/4)
    dllw = outw.dll_disc.cpu().numpy()
    el_bias = np.mean(dllw[:, dllw.shape[1] // 2:], axis=1)
    t = mark("pilot_pass", t)

    aux_epochs = None
    if e1b_waves is not None and n_long is not None:
        n4 = ((min(n_long, (rx.shape[0] - int(istart.max())) // bs) - 1)
              // PILOT_EPOCHS) * PILOT_EPOCHS
        signs_long = np.stack([sc.E1C_SECONDARY[(np.arange(n4) + s_star[i]) % 25]
                               for i in range(n_ch)]).astype(np.float32)
        aux_codes = torch.from_numpy(
            np.stack([np.asarray(w, np.float32) for w in e1b_waves])).to(device)
        samples_l, start_l = _windows(rx, istart, n4 * bs)
        _, outl = tracking.track(cfg_w, pilot_state(), samples_l, codes, aux_code=aux_codes,
                                 aux_per_block=PILOT_EPOCHS, start=start_l,
                                 wipe=signs_long.reshape(n_ch, -1, PILOT_EPOCHS))
        aq = torch.stack((outl.aux_i, outl.aux_q)).cpu().numpy()  # (2, P, n4/4, 4)
        aux = (aq[0] + 1j * aq[1]).reshape(n_ch, -1)  # (P, n4)
        # the CS25 input wipe modulated the data component too: undo it
        aux_epochs = aux * signs_long[:, : aux.shape[1]]
        t = mark("dual_pass", t)
    track_s = time.perf_counter() - t0

    # metrics on the 16 ms pilot prompts (first block dropped: settle)
    pe = pe_all[:, 1:]
    det = acq.detected.cpu().numpy()
    acq_cn0s = acq.cn0_estimate.cpu().numpy()
    per = []
    for i, p in enumerate(prns):
        ii, qq = pe[i].real, pe[i].imag
        m = float(np.mean(ii * ii - qq * qq))
        tot = float(np.mean(ii * ii + qq * qq))
        lock = m / max(tot, 1e-30)
        # lock-based C/N0: mean(I²−Q²) estimates A², the rest 2σ²
        snr = max(m, 1e-12) / max(tot - m, 1e-12)
        cn0 = float(10.0 * np.log10(snr / (PILOT_EPOCHS * t_blk)))
        # acquisition's own estimate shares the front end's quantisation loss
        acq_cn0 = float(acq_cn0s[i])
        ref = acq_cn0 if np.isfinite(acq_cn0) and acq_cn0 > 0 else cn0_cfg_dbhz
        tracked = bool(sec_dom[i] > SEC_DOM_MIN and lock > LOCK_MIN
                       and CN0_WINDOW_DB[0] < cn0 - ref < CN0_WINDOW_DB[1])
        per.append({"prn": int(p), "detected": bool(det[i]), "lock": lock,
                    "sec_dom": float(sec_dom[i]), "sec_shift": int(s_star[i]),
                    "dop_resid_hz": float(dop_resid[i]), "doppler_hz": float(dop_ref[i]),
                    "boc_jump_subchips": float(jump[i]), "el_bias": float(el_bias[i]),
                    "cn0_est_dbhz": cn0, "cn0_acq_dbhz": acq_cn0, "tracked": tracked})
    if e1b_waves is not None:
        return per, track_s, aux_epochs
    return per, track_s


def inav_pages(n_long: int, satellites, seed: int = 77):
    """Each SV's I/NAV pages for `n_long` epochs from `default_rng(seed)`:
    ({prn: [112-bit data]}, the E1B satellites carrying them), drawn in the
    reference's order."""
    rng = np.random.default_rng(seed)
    truth: dict[int, list] = {}
    e1b_sats = []
    for s in satellites:
        pages, datas = [], []
        for _k in range(int(np.ceil(n_long / 500.0)) + 1):
            d112 = rng.integers(0, 2, 112)
            d16 = rng.integers(0, 2, 16)
            datas.append(d112)
            pages.append(inav.encode_page(d112, d16))
        truth[s.prn] = datas
        syms = np.concatenate(pages)
        e1b_sats.append(dataclasses.replace(s, signal="GalileoE1B", nav_data=True,
                                            nav_bits=tuple(int(v) for v in 1 - 2 * syms)))
    return truth, tuple(e1b_sats)


def e1b_inav_phase(cfg, periods: int = 50, duration_s: float = 4.35, device=None,
                   stages: dict | None = None) -> dict:
    """E1B I/NAV decode at the gate's C/N0: the scene again with both E1
    components per SV (the E1C pilots as `cfg`, plus E1B data channels
    carrying I/NAV pages from ``default_rng(77)``), the pilots acquired and
    refined on the dual capture, the long dual pass, and each SV's pages
    decoded (the Viterbi decode of every part in one call on the device).
    Returns the reference's record, with each SV's CRC-ok page data and
    soft symbols."""
    device = resolve_device(device)
    fs = cfg.sample_rate
    n_per = e1c_common.samples_per_period(fs)
    t_ep = 4092 / sc.CHIP_RATE
    n_long = int(duration_s / t_ep)

    _sync(device)
    t0 = time.perf_counter()
    sats = list(cfg.satellites)
    truth, e1b_sats = inav_pages(n_long, sats)
    cfg2 = dataclasses.replace(cfg, satellites=tuple(sats) + e1b_sats)
    n_total = (n_long + 2) * n_per
    rx = sc.GnssScenario(cfg2, device=device).generate_device(n_total / fs)[:n_total]
    _sync(device)
    gen_s = time.perf_counter() - t0

    prns = [s.prn for s in sats]
    waves = e1c_common.e1c_waves(prns)
    e1b_waves = e1c_common.e1c_waves(prns, "GalileoE1B")
    t1 = time.perf_counter()
    acq = e1c_common.acquire_e1c(rx[: periods * n_per], prns, waves, fs, periods)
    _sync(device)
    acquire_s = time.perf_counter() - t1

    _, trk_s, aux = track_channels(rx, fs, prns, waves, acq, periods,
                                      cn0_cfg_dbhz=float(sats[0].cn0_dbhz or 34.0),
                                      e1b_waves=e1b_waves, n_long=n_long, stages=stages)
    t2 = time.perf_counter()
    per_sv, softs = [], []
    svs_ok = 0
    for i, p in enumerate(prns):
        a = aux[i]
        # the constant E1B-vs-pilot phase (independent emitter phases in the
        # scenario): squaring estimate, data-invariant
        phi = 0.5 * np.angle(np.mean(a * a))
        soft = (a * np.exp(-1j * phi)).real
        soft = soft / (np.mean(np.abs(soft)) + 1e-12)
        softs.append(soft)
        pages = inav.decode_stream(soft, device)
        n_ok = sum(1 for g in pages if g["crc_ok"])
        want = {tuple(d.tolist()) for d in truth[p]}
        n_match = sum(1 for g in pages if g["crc_ok"] and tuple(g["data112"].tolist()) in want)
        if n_ok >= 1 and n_match == n_ok:
            svs_ok += 1
        per_sv.append({"prn": int(p), "pages_crc_ok": n_ok, "pages_data_match": n_match,
                       "pages_seen": len(pages),
                       "data112": [g["data112"].tolist() for g in pages if g["crc_ok"]]})
    decode_s = time.perf_counter() - t2
    return {"svs_pages_ok": svs_ok, "of": len(prns), "pass": bool(svs_ok >= min(6, len(prns))),
            "per_sv": per_sv, "epochs": n_long, "gen_s": gen_s, "acquire_s": acquire_s,
            "track_s": trk_s, "decode_s": decode_s, "soft": softs}


def main(periods: int = 50, source=None, device=None) -> dict:
    """The 8-SV pilot gate: capture and acquisition (`e1c_common`), the
    pilot stage over the PRESENT PRNs, then the E1B I/NAV phase on its own
    dual capture. A failure of either phase raises."""
    device = resolve_device(device)
    source = e1c_common.gate_config() if source is None else source
    cfg, rx, all_prns, n_present, all_waves, acq_all, timings = e1c_common.e1c_capture(
        source, periods, device)
    fs = cfg.sample_rate
    prns = all_prns[:n_present]
    waves = all_waves[:n_present]
    acq = acquisition.AcquisitionResult(*[f[:n_present] for f in acq_all])
    stages: dict = {}
    per, track_s = track_channels(rx, fs, prns, waves, acq, periods,
                                  cn0_cfg_dbhz=float(cfg.satellites[0].cn0_dbhz),
                                  stages=stages)
    n_tracked = sum(1 for r in per if r["tracked"])
    cn0s = [r["cn0_est_dbhz"] for r in per if r["tracked"]]
    e1b_stages: dict = {}
    e1b = e1b_inav_phase(cfg, periods, device=device, stages=e1b_stages)
    e1b["stages_s"] = e1b_stages
    det = acq_all.detected.cpu().numpy()
    return {
        "metric": "e1c_tracked", "value": n_tracked, "of": len(prns),
        "acquired": int(det[:n_present].sum()),
        "false_alarms": int(det[n_present:].sum()), "controls": list(all_prns[n_present:]),
        "cn0_mean_dbhz": float(np.mean(cn0s)) if cn0s else None,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "periods": periods, "gen_s": timings["gen_s"], "acquire_s": timings["acquire_s"],
        "track_s": track_s, "stages_s": stages, "per_prn": per, "e1b": e1b,
    }


def e1c_pilot_gate(device=None, periods: int = 50) -> dict:
    """`main` on the 8-SV scene built in code (`e1c_common.gate_config`)
    with the reference's bars: every present PRN acquired and no absent
    control detected; every PRN `tracked`; the E1B phase's pass (≥ 6 of 8
    SVs with CRC-ok pages), every CRC-ok page's 112 data bits equal to the
    truth. Adds each PRN's refined Doppler against the configured one."""
    cfg = e1c_common.gate_config()
    out = main(periods, cfg, device)
    truth = {s.prn: s.doppler_hz for s in cfg.satellites}
    for r in out["per_prn"]:
        r["doppler_err_hz"] = r["doppler_hz"] - truth[r["prn"]]
    e1b = out["e1b"]
    bars = {"acquired": out["acquired"] == out["of"], "false_alarms": out["false_alarms"] == 0,
            "tracked": out["value"] == out["of"], "e1b_pass": e1b["pass"],
            "pages_match": all(sv["pages_data_match"] == sv["pages_crc_ok"]
                               for sv in e1b["per_sv"])}
    out["bars"] = {k: bool(v) for k, v in bars.items()}
    out["ok"] = all(out["bars"].values())
    return out


if __name__ == "__main__":
    out = e1c_pilot_gate(periods=int(sys.argv[1]) if len(sys.argv) > 1 else 50)
    out["e1b"].pop("soft")
    print(json.dumps(out))
