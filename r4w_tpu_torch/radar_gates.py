"""The radar, array and propagation slice's two gates: a 16-element
digital-array pulse-Doppler radar at a full CPI, and the slice's blocks card
against CPU.

`array_radar_gate(device, cpis, seed)` builds a scene in numpy
(`RadarScene`): a 16-element ULA at λ/2 in S band (λ = 0.1 m), 128 pulses
at a PRF of 4 kHz, 4096 range samples a pulse at 20 MS/s (7.5 m bins) and a
200-sample LFM pulse of 10 MHz; unit-power AWGN on every element sample, a
noise jammer at +50° with 30 dB JNR, 40 stationary clutter scatterers of
20 dB each, and five moving targets (`TARGETS`), with a listening interval
of 4096 snapshots of noise and jammer. Each CPI is uploaded once and runs
the reference's own functions on the card (`radar_chain`):
`radar.mvdr_weights` for the 16 beams at once, `radar.mti_filter` and
`radar_sonar.matched_filter_pulses` on the element cube, `radar.beamform`
of all beams in one matrix product, `radar_sonar.pulse_doppler_process`
and `radar.cfar_2d` with the beams as a leading axis. MTI, the matched
filter and the beamformer are linear over different axes and commute, so
the chain filters the elements before it forms the beams: the
element-level matched filter output is also MUSIC's snapshots. No device
value reaches Python before the CFAR masks. The detections are clustered
on the host (`cluster_detections`), each cluster's element snapshots at its
range bin go to `radar.music_spectrum` in one batched call and its peak is
picked on the host (`music_peak`), and the cluster ranges feed
`radar_adv.RadarTracker`. `radar_bars` holds the run to the bars the
reference meets on the same scene; `radar_agreement` holds a card CPI
against a CPU CPI.

`array_blocks_gate(device)` runs each function of ``core.linalg``,
``radar``, ``radar_sonar``, ``radar_adv``, ``beamforming``, ``mimo``,
``propagation`` and ``ew`` on its JAX test's inputs on `device` and on the
CPU: hard decisions equal, floats within the stated tolerance, the SVD and
the eigenvectors by their phase-free invariants. `cfar_1d` is among them,
so the FIR kernel runs at the CFAR window's shape.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from r4w_tpu_torch.core.linalg import complex_lstsq
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, resolve_device
from r4w_tpu_torch.modem_gates import _Stages, _launched, _on, _synchronize, compare, launch_counts
from r4w_tpu_torch.ops import beamforming as bf
from r4w_tpu_torch.ops import ew, mimo, propagation, radar, radar_adv
from r4w_tpu_torch.ops import radar_sonar as rs

ELEMENTS, PULSES, RANGE_BINS = 16, 128, 4096        # one CPI: 16 × 128 × 4096 complex64
SAMPLE_RATE_HZ, PRF_HZ, WAVELENGTH_M = 20e6, 4e3, 0.1
RANGE_BIN_M = 7.5                                   # c / (2·fs)
PULSE_SAMPLES, SWEEP_HZ = 200, 10e6                 # a 10 µs LFM of 10 MHz
JAMMER_DEG, JNR_DB = 50.0, 30.0                     # per element sample
CLUTTER_SCATTERERS, CLUTTER_DB, CLUTTER_DEG = 40, 20.0, (-60.0, 60.0)
LISTEN_SNAPSHOTS = 4096
# (range bin at CPI 0, Doppler Hz, angle deg, SNR dB per element sample)
TARGETS = ((600, 800.0, -20.0, -20.0), (1500, -1200.0, 10.0, -25.0), (2300, 300.0, 35.0, -22.0),
           (3100, -500.0, -45.0, -24.0), (3700, 1500.0, 0.0, -26.0))
MTI_ORDER, GUARD, TRAIN, PFA = 2, 2, 8, 1e-6
MERGE_BINS = 2                                      # clustering: range and Doppler
MUSIC_SOURCES, MUSIC_STEP_DEG = 2, 0.1
CPIS = 5
# bars: the reference's own run on this scene (5 CPIs), with margin
BIN_TOL = 1                                         # planted range and Doppler bins
FALSE_DETECTIONS_MAX = 25                           # a CPI, off every target: 3× 8.3 expected
MVDR_REDUCTION_DB, MVDR_AWAY_DEG = 15.0, 10.0
TRACK_TOL_M, FALSE_TRACKS_MAX = 7.5, 2
# card against CPU
TIE_REL = 1e-5                                      # a cell within this of its threshold is a tie
WEIGHTS_TOL = 1e-4                                  # MVDR weights, max|Δ| over max|CPU|: a solve
MAP_TOL = 1e-5                                      # Doppler maps, max|Δ| over max|CPU|
MUSIC_TOL_DEG = 0.1


def beam_angles_deg(elements: int = ELEMENTS) -> np.ndarray:
    """The beams' looks: sin θ_b = (b − (M − 1)/2)/(M/2), b = 0..M-1."""
    b = np.arange(elements)
    return np.degrees(np.arcsin((b - (elements - 1) / 2.0) / (elements / 2.0)))


def lfm_replica(samples: int = PULSE_SAMPLES, sweep_hz: float = SWEEP_HZ,
                sample_rate: float = SAMPLE_RATE_HZ) -> np.ndarray:
    """The transmit pulse: an LFM from −sweep/2 to +sweep/2, complex64."""
    t = np.arange(samples) / sample_rate
    k = sweep_hz / (samples / sample_rate)
    return np.exp(1j * np.pi * (k * t * t - sweep_hz * t)).astype(np.complex64)


def _steer(elements: int, deg) -> np.ndarray:
    """(…, M) steering in `radar.steering_vector`'s convention, complex128."""
    return np.exp(1j * np.pi * np.sin(np.radians(np.asarray(deg)))[..., None] * np.arange(elements))


def _cn(rng: np.random.Generator, shape, power: float = 1.0) -> np.ndarray:
    """Complex Gaussian of `power`, complex64."""
    re = rng.standard_normal(shape, dtype=np.float32)
    im = rng.standard_normal(shape, dtype=np.float32)
    return ((re + 1j * im) * np.float32(math.sqrt(power / 2.0))).astype(np.complex64)


class RadarScene:
    """The gate's scene at a (elements, pulses, range bins) size, built from
    `seed`: the static clutter and the targets' tracks are drawn once, the
    noise, jammer and target phases anew each CPI. The targets' planted
    range bins are scaled by range_bins/4096, so a small cube keeps them in
    view."""

    def __init__(self, elements: int = ELEMENTS, pulses: int = PULSES,
                 range_bins: int = RANGE_BINS, seed: int = 0):
        self.elements, self.pulses, self.range_bins = elements, pulses, range_bins
        self.rng = np.random.default_rng(seed)
        self.replica = lfm_replica()
        self.cpi_s = pulses / PRF_HZ
        span = range_bins - PULSE_SAMPLES
        r = self.rng
        self.clutter_bins = r.integers(0, span, CLUTTER_SCATTERERS)
        self.clutter_deg = r.uniform(*CLUTTER_DEG, CLUTTER_SCATTERERS)
        self.clutter_phase = r.uniform(0.0, 2.0 * np.pi, CLUTTER_SCATTERERS)
        self.jammer = _steer(elements, JAMMER_DEG).astype(np.complex64)
        scale = range_bins / RANGE_BINS
        self.targets = [(int(round(b * scale)) * RANGE_BIN_M, f, deg, snr)
                        for b, f, deg, snr in TARGETS]

    def truth(self, cpi: int) -> list[dict]:
        """Each target at CPI `cpi`: its range (m), range bin, Doppler bin
        (fftshifted, after MTI) and angle."""
        n_dop = self.pulses - MTI_ORDER
        out = []
        for r0, f_d, deg, snr in self.targets:
            rng_m = r0 - f_d * WAVELENGTH_M / 2.0 * cpi * self.cpi_s   # v = −f_d·λ/2
            out.append({"range_m": rng_m, "range_bin": int(round(rng_m / RANGE_BIN_M)),
                        "doppler_bin": int(round(n_dop // 2 + f_d / PRF_HZ * n_dop)) % n_dop,
                        "deg": deg, "snr_db": snr, "doppler_hz": f_d})
        return out

    def listen(self) -> np.ndarray:
        """(M, 4096) snapshots of noise and jammer, the transmitter off."""
        r = self.rng
        x = _cn(r, (self.elements, LISTEN_SNAPSHOTS))
        x += self.jammer[:, None] * _cn(r, (1, LISTEN_SNAPSHOTS), 10.0 ** (JNR_DB / 10.0))
        return x

    def cube(self, cpi: int) -> np.ndarray:
        """(M, pulses, range bins) complex64 of CPI `cpi`."""
        r, m, p, n = self.rng, self.elements, self.pulses, self.range_bins
        cube = _cn(r, (m, p, n))
        jam = _cn(r, (p, n), 10.0 ** (JNR_DB / 10.0))
        cube += self.jammer[:, None, None] * jam[None]
        prof = np.zeros((CLUTTER_SCATTERERS, n), np.complex64)
        amp = 10.0 ** (CLUTTER_DB / 20.0)
        for s, (b, ph) in enumerate(zip(self.clutter_bins, self.clutter_phase)):
            prof[s, b:b + PULSE_SAMPLES] = amp * np.exp(1j * ph) * self.replica
        cube += (_steer(m, self.clutter_deg).T @ prof).astype(np.complex64)[:, None, :]
        pulse_t = np.arange(p) / PRF_HZ
        for t in self.truth(cpi):
            b = t["range_bin"]
            if not 0 <= b <= n - PULSE_SAMPLES:
                continue
            amp = 10.0 ** (t["snr_db"] / 20.0) * np.exp(1j * r.uniform(0.0, 2.0 * np.pi))
            slow = np.exp(2j * np.pi * t["doppler_hz"] * pulse_t)
            echo = (amp * _steer(m, t["deg"])[:, None, None] * slow[None, :, None]
                    * self.replica[None, None, :])
            cube[:, :, b:b + PULSE_SAMPLES] += echo.astype(np.complex64)
        return cube


def radar_chain(cube: torch.Tensor, listen: torch.Tensor, replica,
                stages: _Stages | None = None) -> dict:
    """One CPI on `cube`'s device, up to the CFAR masks: the MVDR weights
    (beams, M), the element-level matched filter output after MTI (M,
    pulses − 2, range), the Doppler maps (beams, Doppler, range), the CFAR
    masks and thresholds. No device value is read into Python."""
    mark = stages.mark if stages is not None else (lambda name: None)
    weights = radar.mvdr_weights(listen, beam_angles_deg(cube.shape[0]))
    mark("weights")
    elements_mf = rs.matched_filter_pulses(radar.mti_filter(cube, MTI_ORDER), replica)
    mark("mti_matched_filter")
    beams = radar.beamform(elements_mf, weights)
    mark("beamform")
    rd = rs.pulse_doppler_process(beams)
    mark("doppler")
    det, threshold = radar.cfar_2d(rd ** 2, GUARD, TRAIN, PFA)
    mark("cfar")
    return {"weights": weights, "elements_mf": elements_mf, "rd": rd, "det": det,
            "threshold": threshold}


def cluster_detections(cells: np.ndarray, power: np.ndarray) -> list[tuple[int, int, int]]:
    """Clusters of detected cells (K, 3) (beam, Doppler, range) with their
    powers: strongest first, a cell within MERGE_BINS in range and in
    Doppler of a cluster's seed joins it. Returns the seeds (Doppler,
    range, beam), strongest first."""
    order = np.lexsort((np.arange(len(power)), -power))
    seeds: list[tuple[int, int, int]] = []
    for k in order:
        b, d, r = (int(v) for v in cells[k])
        if not any(abs(d - sd) <= MERGE_BINS and abs(r - sr) <= MERGE_BINS for sd, sr, _ in seeds):
            seeds.append((d, r, b))
    return seeds


def music_peak(scan: np.ndarray, spectrum: np.ndarray, look_deg: float) -> float:
    """The local maximum of a MUSIC pseudo-spectrum nearest `look_deg` (a
    plain argmax near the look can pick the jammer's flank)."""
    s = spectrum
    peaks = np.flatnonzero((s[1:-1] > s[:-2]) & (s[1:-1] >= s[2:])) + 1
    if peaks.size == 0:
        return float(scan[int(np.argmax(s))])
    return float(scan[peaks[np.argmin(np.abs(scan[peaks] - look_deg))]])


def music_scan() -> np.ndarray:
    return np.round(np.arange(-900, 901) * MUSIC_STEP_DEG, 1)


def radar_cpi(cube: torch.Tensor, listen: torch.Tensor, replica, tracker, stages: _Stages) -> dict:
    """One CPI on the cube's device: the chain, then the host's clustering,
    MUSIC on every cluster in one call with its peaks picked on the host,
    and one tracker scan."""
    out = radar_chain(cube, listen, replica, stages)
    det, rd = out["det"], out["rd"]
    cells = torch.nonzero(det)
    power = rd[det]
    cells_h, power_h = cells.cpu().numpy(), power.cpu().numpy()
    seeds = cluster_detections(cells_h, power_h)
    stages.mark("clustering")
    looks = beam_angles_deg(cube.shape[0])
    scan = music_scan()
    estimates = []
    if seeds:
        bins = torch.as_tensor([r for _, r, _ in seeds], device=cube.device)
        snaps = torch.index_select(out["elements_mf"], -1, bins).permute(2, 0, 1)  # (C, M, P)
        _, spec = radar.music_spectrum(snaps, MUSIC_SOURCES, 0.5, scan)
        spec_h = spec.cpu().numpy()
        estimates = [music_peak(scan, spec_h[i], looks[b]) for i, (_, _, b) in enumerate(seeds)]
    stages.mark("music")
    confirmed = tracker.step(np.asarray([r for _, r, _ in seeds], np.float64) * RANGE_BIN_M)
    tracks = [(t.track_id, float(t.x[0]), float(t.x[1])) for t in confirmed]
    stages.mark("tracker")
    return {**out, "cells": cells_h, "power": power_h, "clusters": seeds, "music_deg": estimates,
            "tracks": tracks}


def _near(cell: tuple[int, int], truth: dict, tol: int) -> bool:
    return abs(cell[0] - truth["doppler_bin"]) <= tol and abs(cell[1] - truth["range_bin"]) <= tol


def cpi_bars(run: dict, truth: list[dict], elements: int = ELEMENTS) -> dict:
    """One CPI's detection, beam and MUSIC results against the planted
    targets: each target detected within BIN_TOL of its range and Doppler
    bins, the beam of its strongest detection, its cluster's MUSIC angle,
    and the detections off every target (beyond MERGE_BINS)."""
    cells, power = run["cells"], run["power"]
    looks = beam_angles_deg(elements)
    sines = np.sin(np.radians(looks))
    out = {"detected": [], "beam": [], "beam_ok": [], "music_deg": [], "music_err_deg": []}
    off = np.ones(len(cells), bool)
    for t in truth:
        near = np.asarray([_near((d, r), t, BIN_TOL) for _, d, r in cells], bool)
        off &= ~np.asarray([_near((d, r), t, MERGE_BINS) for _, d, r in cells], bool)
        out["detected"].append(bool(near.any()))
        if near.any():
            k = np.flatnonzero(near)[np.argmax(power[near])]
            beam = int(cells[k][0])
            dist = np.abs(sines - np.sin(np.radians(t["deg"])))
            out["beam"].append(beam)
            out["beam_ok"].append(bool(dist[beam] <= dist.min() + 1e-9))
        else:
            out["beam"].append(None)
            out["beam_ok"].append(False)
        est = [deg for (d, r, _), deg in zip(run["clusters"], run["music_deg"])
               if _near((d, r), t, MERGE_BINS)]
        out["music_deg"].append(est[0] if est else None)
        out["music_err_deg"].append(abs(est[0] - t["deg"]) if est else None)
    out["false_detections"] = int(off.sum())
    out["clusters"] = len(run["clusters"])
    return out


def mvdr_reduction_db(weights: torch.Tensor, listen: torch.Tensor,
                      elements: int = ELEMENTS) -> np.ndarray:
    """Each beam's listening-interval power, conventional (a/M) over MVDR, dB."""
    a = radar.steering_vector(elements, 0.5, beam_angles_deg(elements), device=listen.device)
    p_mvdr = torch.mean(torch.abs(radar.beamform(listen, weights)) ** 2, dim=-1)
    p_conv = torch.mean(torch.abs(radar.beamform(listen, a / elements)) ** 2, dim=-1)
    return 10.0 * np.log10((p_conv / p_mvdr).cpu().numpy())


def track_bars(history: list[list[tuple[int, float, float]]], truths: list[list[dict]]) -> dict:
    """From the second CPI on, every target has a confirmed track within
    TRACK_TOL_M of its range; over the run, the confirmed tracks on no
    target (distinct ids)."""
    per_cpi, false_ids = [], set()
    for tracks, truth in zip(history, truths):
        on = [any(abs(x - t["range_m"]) <= TRACK_TOL_M for _, x, _ in tracks) for t in truth]
        per_cpi.append(sum(on))
        for tid, x, _ in tracks:
            if not any(abs(x - t["range_m"]) <= TRACK_TOL_M for t in truth):
                false_ids.add(tid)
    return {"targets_tracked": per_cpi, "false_tracks": len(false_ids),
            "ok": all(n == len(truths[0]) for n in per_cpi[1:]) and len(false_ids) <= FALSE_TRACKS_MAX}


def radar_bars(cpi_results: list[dict], reduction_db: np.ndarray, tracks: dict,
               elements: int = ELEMENTS) -> dict:
    """The gate's bars over the run: every target detected at its planted
    bins (±BIN_TOL) in every CPI and its strongest detection in the beam
    nearest its sine; at most FALSE_DETECTIONS_MAX detections a CPI off
    every target; MVDR at least MVDR_REDUCTION_DB under the conventional
    beam at every beam MVDR_AWAY_DEG or more from the jammer; the tracks."""
    away = np.abs(beam_angles_deg(elements) - JAMMER_DEG) >= MVDR_AWAY_DEG
    worst_mvdr = float(np.min(reduction_db[away]))
    detected = all(all(c["detected"]) for c in cpi_results)
    beams = all(all(c["beam_ok"]) for c in cpi_results)
    false_max = max(c["false_detections"] for c in cpi_results)
    return {"detected": detected, "beams": beams, "false_detections_max": false_max,
            "mvdr_worst_db": worst_mvdr, "tracks": tracks,
            "ok": bool(detected and beams and false_max <= FALSE_DETECTIONS_MAX
                       and worst_mvdr >= MVDR_REDUCTION_DB and tracks["ok"])}


def array_radar_gate(device=DEFAULT_DEVICE, cpis: int = CPIS, seed: int = 0,
                     elements: int = ELEMENTS, pulses: int = PULSES,
                     range_bins: int = RANGE_BINS) -> dict:
    """`cpis` CPIs of the scene made from `seed` through the radar on
    `device`. Returns ``ok`` (the bars), the bars, each CPI's results and
    stage times (CUDA events on the card), the seconds of each CPI end to
    end (upload to tracker, the numpy scene not counted; the first CPI
    separately), the launches of each hand-written kernel, the MVDR
    reductions, and the last CPI's tensors and host inputs (`last`)."""
    device = resolve_device(device)
    scene = RadarScene(elements, pulses, range_bins, seed)
    listen_h = scene.listen()
    replica = torch.from_numpy(scene.replica).to(device)
    tracker = radar_adv.RadarTracker(dt=scene.cpi_s, device=device)
    before = launch_counts()
    listen = torch.from_numpy(listen_h).to(device)
    results, seconds, stage_ms, truths, history = [], [], [], [], []
    last = None
    for k in range(cpis):
        host = scene.cube(k)
        truth = scene.truth(k)
        _synchronize(device)
        t0 = time.perf_counter()
        stages = _Stages(device)
        stages.mark("start")
        cube = torch.from_numpy(host).to(device)
        stages.mark("upload")
        run = radar_cpi(cube, listen, replica, tracker, stages)
        _synchronize(device)
        seconds.append(time.perf_counter() - t0)
        stage_ms.append(stages.ms())
        results.append(cpi_bars(run, truth, elements))
        truths.append(truth)
        history.append(run["tracks"])
        last = {"cube_host": host, "run": run, "cube": cube}
    launches = _launched(before)
    reduction = mvdr_reduction_db(last["run"]["weights"], listen, elements)
    tracks = track_bars(history, truths)
    bars = radar_bars(results, reduction, tracks, elements)
    return {"ok": bars["ok"], "bars": bars, "cpis": results, "stage_ms": stage_ms,
            "seconds": seconds, "launches": launches, "mvdr_reduction_db": reduction.tolist(),
            "truth": truths, "tracks": history, "listen_host": listen_h, "listen": listen,
            "replica": replica, "last": last, "device": str(device),
            "shape": [elements, pulses, range_bins]}


def radar_agreement(card: dict, cpu: dict) -> dict:
    """A card CPI against a CPU CPI of the same cube (`radar_cpi` results):
    the CFAR masks equal but at cells within TIE_REL of the CPU's threshold
    (counted), the cluster lists equal, the MVDR weights within WEIGHTS_TOL
    and the Doppler maps within MAP_TOL of the largest CPU value, and each
    cluster's MUSIC angle within MUSIC_TOL_DEG."""
    rd_cpu, thr = cpu["rd"], cpu["threshold"]
    p = rd_cpu ** 2
    tie = torch.abs(p - thr) <= TIE_REL * torch.abs(thr)
    diff = card["det"].cpu() != cpu["det"]
    res = {"ties": int(torch.sum(tie)), "mask_differs": int(torch.sum(diff)),
           "mask_differs_off_ties": int(torch.sum(diff & ~tie)),
           "clusters_equal": card["clusters"] == cpu["clusters"],
           "clusters": len(cpu["clusters"]),
           "weights_rel": compare(card["weights"], cpu["weights"]),
           "map_rel": compare(card["rd"], rd_cpu)}
    music = [abs(a - b) for a, b in zip(card["music_deg"], cpu["music_deg"])]
    res["music_worst_deg"] = max(music) if music else 0.0
    res["ok"] = (res["mask_differs_off_ties"] == 0 and res["clusters_equal"]
                 and res["weights_rel"] <= WEIGHTS_TOL and res["map_rel"] <= MAP_TOL
                 and res["music_worst_deg"] <= MUSIC_TOL_DEG)
    return res


def cpi_on(device, cube_host: np.ndarray, listen_host: np.ndarray) -> dict:
    """One CPI of a host cube on `device` with a fresh tracker (for
    `radar_agreement`)."""
    device = resolve_device(device)
    tracker = radar_adv.RadarTracker(dt=cube_host.shape[1] / PRF_HZ, device=device)
    return radar_cpi(torch.from_numpy(cube_host).to(device),
                     torch.from_numpy(listen_host).to(device),
                     torch.from_numpy(lfm_replica()).to(device), tracker, _Stages(device))


# ------------------------------------------------------------ blocks gate

BLOCKS_TOL = 1e-5          # max|card − CPU| / max|CPU|: FFTs, sums and products in another order
BLOCKS_SOLVE_TOL = 1e-3    # solves of ill-conditioned covariances (STAP, LCMV)
BLOCKS_LOOP_TOL = 1e-4     # NLMS step loops, Gauss-Newton, spectral divisions by small bins
CFAR_WINDOW = (64, 4096)   # cfar_1d's rows × cells: the FIR kernel at the CFAR window's shape


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _cplx(rng, *shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(
        np.complex64)


def _chirp(n: int, k: float = 0.5) -> np.ndarray:
    t = np.arange(n) / n
    return np.exp(1j * np.pi * k * n * t * t).astype(np.complex64)


def _svd_invariants(h):
    f, wh, s = bf.mimo_precode_svd(h)
    return s, wh.mH @ torch.diag(s).to(wh.dtype) @ f.mH


def _music(x, scan):
    _, spec = radar.music_spectrum(x, 2, 0.5, scan)
    return spec


def _tracker(z):
    """The tracker on `z`'s device over 20 scans of two targets and a stray
    detection (z: the detections, (20, 3))."""
    tr = radar_adv.RadarTracker(0.1, gate=15.0, device=z.device)
    out = []
    for row in z.cpu().numpy():
        out.append(np.asarray([[t.track_id, t.x[0], t.x[1]] for t in tr.step(row)], np.float32))
    return out


def _blocks_cases():
    """(name, function, numpy inputs as (args, kwargs), tolerance): the
    inputs of each function's JAX test (tests/test_radar_sonar.py,
    test_radar_adv.py, test_beamforming.py, test_mimo_sova.py,
    test_cognitive_propagation.py, test_ew_ops.py, test_ops_gaps.py and the
    known-answer files)."""
    tol, stol, ltol = BLOCKS_TOL, BLOCKS_SOLVE_TOL, BLOCKS_LOOP_TOL
    r = _rng(45)
    rep16 = _chirp(16)
    cube = 0.01 * _cplx(r, 32, 128)
    for p in range(32):
        cube[p, 40:56] += rep16 * np.exp(2j * np.pi * 0.2 * p)
    cfar_p = r.exponential(1.0, CFAR_WINDOW).astype(np.float32)
    cfar_p[:, 1234] += 300.0
    ula = (np.exp(1j * np.pi * np.outer(np.arange(8), np.sin(np.deg2rad([-20.0, 35.0]))))
           @ _cplx(r, 2, 400) + 0.1 * _cplx(r, 8, 400)).astype(np.complex64)
    pings = np.zeros((16, 4096), np.complex64)
    positions = np.linspace(-2.0, 2.0, 16)
    for i, px in enumerate(positions):
        k = int(2 * np.sqrt((0.3 - px) ** 2 + 144.0) / 1500.0 * 100e3)
        pings[i, k:k + 32] += _chirp(32)
    scan = np.zeros((360, 64), np.float32)
    scan[90, 32] = 1.0
    pulses = np.zeros(4096, np.complex64)
    pulses[500:700] = np.exp(2j * np.pi * 0.05 * np.arange(200))
    pulses[2000:2100] = 0.5 * np.exp(-2j * np.pi * 0.03 * np.arange(100))
    fmcw = np.exp(1j * (2 * np.pi * 10 * np.arange(64)[None, None, :] / 64
                        + 0.5 * np.arange(4)[:, None, None]
                        + 2 * np.pi * 0.25 * np.arange(16)[None, :, None])).astype(np.complex64)
    lidar_t = np.exp(-0.5 * ((np.arange(21) - 10) / 3.0) ** 2).astype(np.float32)
    lidar_w = np.zeros(512, np.float32)
    lidar_w[100:121] += lidar_t
    lidar_w[300:321] += 0.7 * lidar_t
    otdr = (-0.002 * np.arange(2000)).astype(np.float32)
    otdr[800:] -= 0.8
    otdr[1400] += 1.5
    echo = np.zeros(4096, np.float32)
    echo[500 + 340 * np.arange(5)] = 0.8 ** np.arange(5)
    weather = (np.ones((64, 16)) + 0.3 * np.exp(2j * np.pi * 0.2 * np.arange(64))[:, None])
    stap = (np.sqrt(0.005) * _cplx(r, 120, 32)).astype(np.complex64)
    for i in range(120):
        for fs in r.uniform(-0.5, 0.5, 6):
            stap[i] += _cplx(r, 1)[0] * radar_adv.space_time_steering(4, 8, fs, fs, "cpu").numpy()
    v_tgt = radar_adv.space_time_steering(4, 8, 0.1, -0.35, "cpu").numpy()
    dets = np.stack([[500.0 + 5.0 * k, 900.0 - 8.0 * k, 100.0 + 37.0 * k] for k in range(20)])
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))).astype(np.complex64)
    h42, h22 = _cplx(r, 4, 2), _cplx(r, 2, 2)
    x_ml = qpsk[r.integers(0, 4, (400, 2))]
    y_ml = (x_ml @ h22.T + 0.35 * _cplx(r, 400, 2)).astype(np.complex64)
    tx_si = _cplx(r, 6000)
    t8 = np.arange(4000)
    gsc_x = (np.outer(np.exp(1j * np.pi * np.arange(8) * 0.0), np.exp(2j * np.pi * 0.01 * t8))
             + 3 * np.outer(np.exp(1j * np.pi * np.arange(8) * np.sin(np.deg2rad(40.0))),
                            np.exp(2j * np.pi * 0.013 * t8)) + 0.01 * _cplx(r, 8, 4000))
    sound_tx = _cplx(r, 1024)
    x_ls = _cplx(r, 512)
    y_ls = np.convolve(x_ls, np.asarray([1.0, 0.0, 0.4 - 0.2j, 0.0, 0.1]))[:512]
    tle = propagation.Tle.parse(
        "1 25544U 98067A   26047.50000000  .00016717  00000-0  10270-3 0  9000",
        "2 25544  51.6400 208.9163 0006317  69.9862 290.2000 15.54225995 10000")
    site = 6371e3 * np.array([np.cos(np.deg2rad(28.9)), np.sin(np.deg2rad(28.9)), 0.0])
    mode_f = np.linspace(2e6, 30e6, 200)
    mode_resp = np.exp(-((mode_f - 7e6) / 1e6) ** 2) + 0.6 * np.exp(-((mode_f - 14e6) / 1e6) ** 2)
    esprit = (np.exp(2j * np.pi * 0.11 * np.arange(200))[:, None]
              * np.exp(-2j * np.pi * 0.5 * np.arange(8) * np.sin(np.radians(-20.0)))[None, :]
              + np.exp(2j * np.pi * 0.18 * np.arange(200))[:, None]
              * np.exp(-2j * np.pi * 0.5 * np.arange(8) * np.sin(np.radians(25.0)))[None, :]
              + 0.1 * _cplx(r, 200, 8))
    ref_pr = _cplx(r, 2048)
    surv_pr = (0.3 * np.roll(ref_pr, 17) * np.exp(2j * np.pi * 0.05 * np.arange(2048))
               + 0.01 * _cplx(r, 2048))
    dsi = (ref_pr + 0.5 * np.roll(ref_pr, 3) + 0.01 * np.roll(ref_pr, 200))
    recv = np.asarray([[0.0, 0.0], [1000.0, 0.0], [0.0, 1000.0], [1000.0, 1000.0]])
    dist = np.linalg.norm(recv - np.asarray([420.0, 310.0]), axis=1)
    elint = np.zeros(20000, np.complex64)
    for k in range(8):
        elint[1000 + 2000 * k:1200 + 2000 * k] = np.exp(2j * np.pi * 0.1 * np.arange(200))
    elint += 0.01 * _cplx(r, 20000)
    esm = (np.exp(2j * np.pi * 0.11 * np.arange(1 << 16))
           + 0.5 * np.exp(-2j * np.pi * 0.23 * np.arange(1 << 16)) + 0.05 * _cplx(r, 1 << 16))
    sar_r = np.exp(1j * np.pi * 0.03 * np.arange(32) ** 2)
    sar_a = np.exp(1j * np.pi * 0.01 * (np.arange(64) - 32.0) ** 2)
    sar_raw = ew.sar_point_target(64, 128, 40, 0, sar_r, sar_a)
    return [
        # core.linalg (tests/test_cognitive_propagation.py's LS estimate)
        ("linalg.complex_lstsq", complex_lstsq, ((_cplx(r, 64, 8), _cplx(r, 64)), {}), stol),
        # radar (tests/test_ops_gaps.py, test_known_answers_r4d.py)
        ("radar.pulse_compress", radar.pulse_compress, ((_cplx(r, 3, 2048), _chirp(512, 0.8)), {}),
         tol),
        ("radar.cfar_1d", lambda p: radar.cfar_1d(p, 2, 8, 1e-3), ((cfar_p,), {}), tol),
        ("radar.cfar_2d", lambda p: radar.cfar_2d(p, 1, 4, 1e-6), ((cfar_p[:64, :64],), {}), tol),
        ("radar.range_doppler_map", radar.range_doppler_map, ((cube, rep16), {}), tol),
        ("radar.mti_filter", radar.mti_filter, ((cube,), {}), tol),
        ("radar.steering_vector", lambda a: radar.steering_vector(8, 0.5, a),
         ((np.linspace(-90, 90, 3601),), {}), tol),
        ("radar.music_spectrum", _music, ((ula, np.arange(-90.0, 90.1, 0.5)), {}), stol),
        ("radar.mvdr_weights", lambda x: radar.mvdr_weights(x, [10.0, -40.0], 0.5, 1e-4),
         ((ula,), {}), stol),
        ("radar.beamform", radar.beamform, ((ula, _cplx(r, 3, 8)), {}), tol),
        ("radar.ambiguity_function", lambda p: radar.ambiguity_function(p, 16),
         ((_chirp(256, 1.0),), {}), tol),
        # radar_sonar (tests/test_radar_sonar.py and the known-answer files)
        ("radar_sonar.pulse_doppler", lambda c, p: (
            rs.matched_filter_pulses(c, p), rs.pulse_doppler_process(c, p),
            rs.range_doppler_detect(c, p), rs.isar_image(c, p),
            rs.range_migration_correct(c, -0.5)), ((cube, rep16), {}), tol),
        ("radar_sonar.doppler", lambda x: (
            rs.doppler_pre_correct(x, 37.0, 1000.0), rs.parametric_doppler_estimate(x, 1000.0),
            rs.tracking_doppler_estimate(x.reshape(4, 128), 1000.0),
            rs.wind_profile(x.reshape(64, 8), 1000.0, None)),
         ((np.exp(2j * np.pi * 37.0 * np.arange(512) / 1000.0).astype(np.complex64),), {}), tol),
        ("radar_sonar.range_velocity_decouple", lambda a, b, ax: rs.range_velocity_decouple(
            a, b, ax, None), ((r.random((8, 32)), r.random((8, 32)), np.linspace(0, 1e4, 32)), {}),
         tol),
        ("radar_sonar.bistatic_range_doppler", lambda a, b: rs.bistatic_range_doppler(a, b, 8, 128),
         ((ref_pr[:1024], 0.5 * np.roll(ref_pr[:1024], 37)), {}), tol),
        ("radar_sonar.sas_image", lambda p, rp, pos, x, y: rs.sas_image(p, rp, pos, x, y),
         ((pings, _chirp(32), positions, np.linspace(-1, 1, 21), np.linspace(11, 13, 21)), {}), tol),
        ("radar_sonar.sonar", lambda rx, rp, b: (rs.sonar_process(rx, rp, 100e3),
                                                 rs.bottom_profile(b, 100e3)),
         ((np.roll(np.pad(0.01 * _chirp(64), (0, 4032)), 1000), _chirp(64),
           np.pad(np.ones((3, 20)), ((0, 0), (400, 1628)))), {}), tol),
        ("radar_sonar.radar_display_ppi", lambda s: rs.radar_display_ppi(s, 101), ((scan,), {}),
         tol),
        ("radar_sonar.classify", lambda x: (rs.radar_waveform_features(x, 1e6),
                                            rs.radar_waveform_classify(x, 1e6)),
         ((_chirp(4096, 0.8),), {}), tol),
        ("radar_sonar.pulse_descriptors", lambda x: rs.pulse_descriptors(x, 1e6), ((pulses,), {}),
         tol),
        ("radar_sonar.fmcw_automotive", rs.fmcw_automotive, ((fmcw,), {}), tol),
        ("radar_sonar.lidar", lambda w, t, rr: (rs.lidar_peak_match(w, t), rs.lidar_point_cloud(
            rr, rr * 3.0, rr * 0.3)), ((lidar_w, lidar_t, r.uniform(1, 30, 50)), {}), tol),
        ("radar_sonar.gpr", lambda t: (rs.gpr_image(t), rs.gpr_discriminate(rs.gpr_image(t), 8)),
         ((r.standard_normal((32, 256)),), {}), tol),
        ("radar_sonar.otdr_ndt", lambda y, e: (rs.otdr_analyze(y, 1e9), rs.ndt_thickness(
            e, 100e6, 5900.0)), ((otdr, echo), {}), tol),
        ("radar_sonar.weather", lambda c: (rs.weather_clutter_suppress(c), rs.rcs_estimate(
            1e-12, 1e3, 100.0, 100.0, 0.03, 1000.0)), ((weather,), {}), tol),
        # radar_adv (tests/test_radar_adv.py)
        ("radar_adv.stap", lambda s, v: (radar_adv.stap_weights(s, v), radar_adv.stap_output(
            radar_adv.stap_weights(s, v), s)), ((stap, v_tgt), {}), stol),
        ("radar_adv.integration", lambda p: (radar_adv.clutter_notch(p),
                                             radar_adv.coherent_integrate(p),
                                             radar_adv.noncoherent_integrate(p)),
         ((cube[:16, :64],), {}), tol),
        ("radar_adv.RadarTracker", _tracker, ((dets,), {}), tol),
        # beamforming (tests/test_beamforming.py)
        ("beamforming.detect", lambda y, h: (bf.mimo_detect_zf(y, h), bf.mimo_detect_mmse(
            y, h, 1e-4)), ((_cplx(r, 100, 4), h42), {}), tol),
        ("beamforming.mimo_detect_ml", lambda y, h, c: bf.mimo_detect_ml(y, h, c),
         ((y_ml, h22, qpsk), {}), tol),
        ("beamforming.mimo_precode_svd", _svd_invariants, ((_cplx(r, 3, 3),), {}), tol),
        ("beamforming.stbc_noma", lambda s, h, y: (
            bf.ostbc34_decode(torch.einsum("bsa,a->bs", bf.ostbc34_encode(s), h), h),
            bf.noma_decode_near(y, torch.as_tensor(qpsk, device=y.device), 0.1),
            bf.spatial_multiplex([s, s])),
         ((qpsk[r.integers(0, 4, 30)], _cplx(r, 4), _cplx(r, 500)), {}), tol),
        ("beamforming.arrays", lambda h: (
            bf.null_steer_weights(8, 0.0, [30.0], device=h.device),
            bf.array_response(8, np.arange(-90, 91, 1.0), device=h.device),
            bf.mmwave_beam_search(h, 5), bf.beam_steering_phases(8, 20.0, 0.5, 2, device=h.device),
            bf.ris_phase_config(h, h.conj(), 3), bf.oam_beam(16, 3, device=h.device),
            bf.ultrasound_focus_delays(8, 1e-3, 20e-3, device=h.device),
            bf.delay_and_sum(h.reshape(4, 4), [0, 1, 2, 3])),
         ((_cplx(r, 16),), {}), stol),
        ("beamforming.gsc_cancel", lambda x: bf.gsc_cancel(x, 0.0), ((gsc_x,), {}), ltol),
        ("beamforming.self_interference_cancel", lambda si, tx: bf.self_interference_cancel(
            si, tx, 8), ((0.9 * tx_si + 0.3 * np.roll(tx_si, 3), tx_si), {}), ltol),
        # mimo (tests/test_mimo_sova.py)
        ("mimo.alamouti", lambda s, h: mimo.alamouti_decode(
            h[0] * mimo.alamouti_encode(s)[0] + h[1] * mimo.alamouti_encode(s)[1], h),
         ((qpsk[r.integers(0, 4, 512)], _cplx(r, 2)), {}), tol),
        ("mimo.combining", lambda rx, h: (mimo.mrc_combine(rx, h), mimo.egc_combine(rx, h),
                                          mimo.selection_combine(rx, h)),
         ((_cplx(r, 4, 4096), _cplx(r, 4)), {}), tol),
        ("mimo.sic_decode", lambda rx, c, g: mimo.sic_decode(rx, c, g),
         ((qpsk[r.integers(0, 4, 2048)] + 0.35 * qpsk[r.integers(0, 4, 2048)]
           + 0.03 * _cplx(r, 2048), qpsk, np.asarray([1.0, 0.35])), {}), tol),
        ("mimo.waterfilling", lambda g: (mimo.waterfilling(g, 4.0), mimo.waterfilling(g, 0.0)),
         ((np.asarray([1.0, 0.8, 0.4, 0.1]),), {}), tol),
        ("mimo.leading_edge_toa", lambda c: mimo.leading_edge_toa(c, 1e9),
         ((np.pad(np.asarray([0.3, 0.0, 0.0, 1.0]), (40, 212)).astype(np.complex64),), {}), tol),
        # propagation (tests/test_cognitive_propagation.py, test_known_answers_r4c.py)
        ("propagation.tle_propagate", lambda t: propagation.tle_propagate(tle, t),
         ((np.arange(0, 5400, 60.0),), {}), tol),
        ("propagation.pass_predict", lambda s, t: propagation.pass_predict(tle, s, t, 0.0),
         ((site, np.arange(0, 6 * 5400, 30.0)), {}), tol),
        ("propagation.sounding", lambda tx: (
            propagation.freq_domain_sound(tx, tx + 0.5 * torch.roll(tx, 37)),
            propagation.multipath_profile(tx, tx + 0.5 * torch.roll(tx, 37), 2),
            propagation.sparse_multipath_equalize(tx + 0.5 * torch.roll(tx, 37),
                                                  [(0, 1.0 + 0j), (37, 0.5 + 0j)], 1024)),
         ((sound_tx,), {}), ltol),   # H = R·T*/(|T|² + 1e-6): rounding grows where |T| is small
        ("propagation.ls_channel_estimate", lambda x, y: propagation.ls_channel_estimate(x, y, 5),
         ((x_ls, y_ls), {}), stol),
        ("propagation.mode_sound", propagation.mode_sound, ((mode_resp, mode_f), {}), tol),
        # ew (tests/test_ew_ops.py, test_ops_gaps.py)
        ("ew.esprit", lambda x: (torch.as_tensor(ew.esprit_doa(x, 2)),
                                 torch.as_tensor(ew.esprit_frequencies(x[:, 0], 2, 24))),
         ((esprit,), {}), stol),
        ("ew.sar_process", lambda raw, a, b: ew.sar_process(raw, a, b),
         ((sar_raw, sar_r, sar_a), {}), tol),
        ("ew.passive", lambda a, b, c: (ew.cross_ambiguity(a, b, 32)[0], ew.cancel_dsi(a, c, 8)),
         ((ref_pr, surv_pr, dsi), {}), stol),
        ("ew.gcc_phat", lambda a: ew.gcc_phat(a, torch.roll(a, -25), 64),
         ((ref_pr[:1024],), {}), tol),
        ("ew.tdoa_localize", ew.tdoa_localize, ((recv, dist[1:] - dist[0]), {}), ltol),
        ("ew.elint_esm", lambda x, y: (
            {k: torch.as_tensor(v) for k, v in ew.pulse_characterize(x, 1e6).items()},
            [torch.as_tensor([e["freq_hz"], e["power_db"], e["bandwidth_hz"]])
             for e in ew.esm_scan(y, 1e6)]), ((elint, esm), {}), ltol),
    ]


def array_blocks_gate(device=DEFAULT_DEVICE) -> dict:
    """Every case of `_blocks_cases` on `device` and on the CPU (the worst
    difference a case, inf for differing decisions; each held to its
    tolerance). Returns ``ok``, ``worst`` by case, ``failed`` and the FIR
    kernel's launches (``cfar_1d``'s window sums)."""
    device = resolve_device(device)
    cpu = torch.device("cpu")
    worst, failed = {}, []
    before = launch_counts()
    for name, fn, (args, kwargs), tol in _blocks_cases():
        got = fn(*_on(list(args), device), **kwargs)
        want = fn(*_on(list(args), cpu), **kwargs)
        worst[name] = compare(got, want)
        if not worst[name] <= tol:
            failed.append(name)
    return {"ok": not failed, "worst": worst, "failed": failed, "launches": _launched(before),
            "device": str(device)}
