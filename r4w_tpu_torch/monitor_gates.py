"""The stream-processing and detection slice's two gates: a wideband
spectrum monitor at full width, and the slice's blocks card against CPU.

`spectrum_monitor_gate(device, rows, sample_rate, seed)` builds a capture
of `rows` blocks of 2^20 complex64 samples at 30.72 MS/s in numpy
(`monitor_capture`): unit-power complex AWGN and four FM emitters keyed in
bursts, one second of a 20 MHz band as an SDR records it and hands it to
the DSP in blocks. It uploads it once and runs the reference's own
functions on it (`spectrum_monitor_chain`): `detect.spectrum_sense` over
the whole capture, the occupied bins grouped; per group
`stream_math.digital_down_convert` on the (rows, 2^20) view by 32 (one
`nco_mix` and one `fir_decimate` launch); then, on the four channels
stacked as rows, `detect.burst_detect` with `detect.burst_edges`,
`stream_blocks.power_squelch`, `stream_blocks.envelope_detector` and
`stream_blocks.peak_hold`, each of the last three one launch of the
recursion kernel for all four rows. `monitor_bars` holds the result to the
bars the reference meets on the same capture; `monitor_agreement` holds a
card run against a CPU run.

`dsp_blocks_gate(device)` runs each function of ``stream_math``,
``filters2``, ``stream_blocks``, ``detect``, ``adaptive`` and ``kalman`` on
its JAX test's inputs (tests/test_detect_streammath.py,
tests/test_filters2.py, tests/test_stream_blocks.py,
tests/test_adaptive_kalman.py) on `device` and on the CPU: hard decisions
equal, floats within the stated tolerance. Then each recursion kind at
(4, 2^20) on `device` against the plain version, bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, REAL_DTYPE, resolve_device
from r4w_tpu_torch.kernels import recurrence
from r4w_tpu_torch.modem_gates import _Stages, _launched, _on, _synchronize, compare, launch_counts
from r4w_tpu_torch.ops import adaptive, detect, filters2, kalman, stream_blocks as sb
from r4w_tpu_torch.ops import stream_math as sm
from r4w_tpu_torch.ops.events import latest_set

MONITOR_RATE_HZ = 30.72e6           # an LTE 20 MHz capture rate
MONITOR_BLOCK = 1 << 20             # samples a block (row) handed to the DSP
MONITOR_ROWS = 32                   # 33.55 M samples, 1.092 s
EMITTERS_HZ = (-9.60e6, -3.84e6, 2.88e6, 10.56e6)  # each a multiple of the 30 kHz bin
EMITTER_TONE_HZ, EMITTER_DEVIATION_HZ = 1e3, 5e3   # an FM voice tone
FIRST_START_S, BURST_S, GAP_S = (2e-3, 20e-3), (5e-3, 20e-3), (10e-3, 40e-3)  # uniform ranges
SENSE_NFFT, SENSE_THRESHOLD_DB, GROUP_BINS = 1024, 8.0, 8
MONITOR_DECIMATION = 32             # 960 kS/s channels
BURST_FRAME, BURST_ON_DB, BURST_OFF_DB = 64, 10.0, 6.0
SQUELCH_DB, SQUELCH_ALPHA = -6.0, 0.01
PEAK_DECAY = 0.999
# bars: the reference's own run on this capture (32 rows), with margin
EDGE_TOL_FRAMES = 2
OPEN_SKIP, CLOSE_SKIP = 200, 600    # channel samples skipped after each start / stop
SQUELCH_SHARE = 0.999
ENVELOPE_IN, ENVELOPE_OUT = (1.0, 1.5), 0.5
PEAK_RANGE = (1.0, 2.0)
# card against CPU
TIE_REL = 1e-5                      # a decision within this of its threshold (relative) is a tie
SERIES_TOL = 1e-5                   # envelope and peak hold: max|Δ| over the largest value
DDC_TOL = 1e-5                      # the channels: max|Δ| over max|CPU|
MONITOR_RECURSIONS = {"ema": 1, "attack_release": 1, "peak_hold": 1}


def _bursts(rng: np.random.Generator, n: int, rate: float) -> list[tuple[int, int]]:
    """[start, stop) sample ranges of one emitter's bursts that end inside
    the capture."""
    out = []
    t = rng.uniform(*FIRST_START_S)
    while True:
        stop = t + rng.uniform(*BURST_S)
        if stop * rate >= n:
            return out
        out.append((int(round(t * rate)), int(round(stop * rate))))
        t = stop + rng.uniform(*GAP_S)


def monitor_capture(rows: int = MONITOR_ROWS, sample_rate: float = MONITOR_RATE_HZ,
                    seed: int = 0):
    """(capture (rows, 2^20) complex64, each emitter's bursts as [start,
    stop) sample ranges), built in numpy from `seed`: unit-power complex
    AWGN plus the four emitters, each an FM tone of amplitude 1.0 with a
    random start phase (its phase in float64), keyed on and off."""
    n = rows * MONITOR_BLOCK
    rng = np.random.default_rng(seed)
    cap = (rng.standard_normal(n, dtype=np.float32)
           + 1j * rng.standard_normal(n, dtype=np.float32)).astype(np.complex64)
    cap *= np.float32(np.sqrt(0.5))
    planted = []
    for f_hz in EMITTERS_HZ:
        bursts = _bursts(rng, n, sample_rate)
        phase0 = rng.uniform(0.0, 2.0 * np.pi)
        for start, stop in bursts:
            t = np.arange(start, stop) / sample_rate
            phase = (phase0 + 2.0 * np.pi * f_hz * t
                     + EMITTER_DEVIATION_HZ / EMITTER_TONE_HZ * np.sin(2.0 * np.pi * EMITTER_TONE_HZ * t))
            cap[start:stop] += np.exp(1j * phase).astype(np.complex64)
        planted.append(bursts)
    return cap.reshape(rows, MONITOR_BLOCK), planted


def _groups(occupied: np.ndarray, psd_db: np.ndarray) -> list[int]:
    """The centre bin (fftshifted, of the strongest PSD) of each group of
    occupied bins lying within GROUP_BINS of each other."""
    bins = np.flatnonzero(np.fft.fftshift(occupied))
    groups = np.split(bins, np.flatnonzero(np.diff(bins) > GROUP_BINS) + 1) if bins.size else []
    return [int(g[np.argmax(psd_db[g])]) for g in groups]


def spectrum_monitor_chain(capture: torch.Tensor, sample_rate: float = MONITOR_RATE_HZ) -> dict:
    """The monitor on a (rows, 2^20) capture: the occupied groups' centres,
    the four channels (4, rows·2^15) and their burst masks, squelched
    channels, envelopes and peak holds, with each stage's milliseconds."""
    stages = _Stages(capture.device)
    stages.mark("start")
    occupied, psd_db = detect.spectrum_sense(capture.reshape(-1), nfft=SENSE_NFFT,
                                             threshold_db=SENSE_THRESHOLD_DB)
    stages.mark("spectrum_sense")
    centres = _groups(occupied.cpu().numpy(), psd_db.cpu().numpy())
    bin_hz = sample_rate / SENSE_NFFT
    channels = torch.stack([
        sm.digital_down_convert(capture, (k - SENSE_NFFT // 2) * bin_hz, sample_rate,
                                MONITOR_DECIMATION).reshape(-1) for k in centres])
    stages.mark("digital_down_convert")
    mask = detect.burst_detect(channels, BURST_FRAME, BURST_ON_DB, BURST_OFF_DB)
    stages.mark("burst_detect")
    squelched, _ = sb.power_squelch(channels, SQUELCH_DB, alpha=SQUELCH_ALPHA)
    stages.mark("power_squelch")
    envelope, _ = sb.envelope_detector(channels)
    stages.mark("envelope_detector")
    peak, _ = sb.peak_hold(channels, decay=PEAK_DECAY)
    stages.mark("peak_hold")
    return {"centres": centres, "occupied": occupied, "psd_db": psd_db, "channels": channels,
            "mask": mask, "squelched": squelched, "envelope": envelope, "peak": peak,
            "stage_ms": stages.ms()}


def _planted_frames(bursts, decimation: int) -> tuple[np.ndarray, np.ndarray]:
    """The bursts' start and stop frames at the channel rate."""
    per_frame = decimation * BURST_FRAME
    return (np.asarray([a // per_frame for a, _ in bursts], np.int64),
            np.asarray([b // per_frame for _, b in bursts], np.int64))


def _regions(planted, n_channel: int, decimation: int) -> tuple[np.ndarray, np.ndarray]:
    """(inside, outside) (4, n_channel) bool: each burst after its first
    OPEN_SKIP channel samples, and away from the bursts and the CLOSE_SKIP
    samples after each stop."""
    inside = np.zeros((len(planted), n_channel), bool)
    outside = np.ones_like(inside)
    for i, bursts in enumerate(planted):
        for start, stop in bursts:
            a, b = start // decimation, stop // decimation
            inside[i, a + OPEN_SKIP:b] = True
            outside[i, a:b + CLOSE_SKIP] = False
    return inside, outside


def _bar_tensors(out: dict, inside: torch.Tensor, outside: torch.Tensor) -> dict:
    """The bars' device reductions, one value a channel."""
    gate = out["squelched"] != 0
    env = out["envelope"]
    return {"open": [torch.mean(gate[i][inside[i]].to(REAL_DTYPE)) for i in range(gate.shape[0])],
            "closed": [torch.mean((~gate[i][outside[i]]).to(REAL_DTYPE))
                       for i in range(gate.shape[0])],
            "env_in": [torch.median(env[i][inside[i]]) for i in range(env.shape[0])],
            "env_out": [torch.median(env[i][outside[i]]) for i in range(env.shape[0])],
            "peak": torch.amax(out["peak"], dim=-1)}


def monitor_bars(out: dict, planted, sample_rate: float = MONITOR_RATE_HZ,
                 values: dict | None = None) -> dict:
    """The gate's bars on a chain's outputs: 4 groups, each centre within a
    bin of its emitter; on each channel every planted burst found, each
    start and stop within EDGE_TOL_FRAMES; the squelch open on
    SQUELCH_SHARE of in-burst samples and closed on SQUELCH_SHARE of the
    rest; the envelope's medians in ENVELOPE_IN and below ENVELOPE_OUT; the
    peak hold's maximum in PEAK_RANGE."""
    want_bins = sorted(int(round(f / (sample_rate / SENSE_NFFT))) + SENSE_NFFT // 2
                       for f in EMITTERS_HZ)
    centres = out["centres"]
    groups_ok = len(centres) == len(want_bins) and all(
        abs(c - w) <= 1 for c, w in zip(centres, want_bins))
    if values is None:
        n_channel = out["channels"].shape[-1]
        inside, outside = (torch.from_numpy(r).to(out["channels"].device)
                           for r in _regions(planted, n_channel, MONITOR_DECIMATION))
        values = _bar_tensors(out, inside, outside)
    bars = {"centre_bins": centres, "planted_bins": want_bins, "groups_ok": groups_ok,
            "bursts": [], "bursts_planted": [], "worst_edge_frames": 0}
    mask = out["mask"].cpu().numpy()
    bursts_ok = groups_ok
    for i, bursts in enumerate(planted[:len(centres)]):
        starts, stops = detect.burst_edges(mask[i])
        want_starts, want_stops = _planted_frames(bursts, MONITOR_DECIMATION)
        bars["bursts"].append(int(starts.shape[0]))
        bars["bursts_planted"].append(len(bursts))
        if starts.shape[0] != len(bursts):
            bursts_ok = False
            continue
        worst = int(max(np.max(np.abs(starts - want_starts), initial=0),
                        np.max(np.abs(stops - want_stops), initial=0)))
        bars["worst_edge_frames"] = max(bars["worst_edge_frames"], worst)
    bursts_ok = bursts_ok and bars["worst_edge_frames"] <= EDGE_TOL_FRAMES
    for key in ("open", "closed", "env_in", "env_out"):
        bars[key] = [float(v) for v in values[key]]
    bars["peak_max"] = float(torch.max(values["peak"]))
    bars["ok"] = bool(
        bursts_ok and min(bars["open"]) >= SQUELCH_SHARE and min(bars["closed"]) >= SQUELCH_SHARE
        and all(ENVELOPE_IN[0] <= v <= ENVELOPE_IN[1] for v in bars["env_in"])
        and max(bars["env_out"]) < ENVELOPE_OUT
        and PEAK_RANGE[0] <= bars["peak_max"] <= PEAK_RANGE[1])
    return bars


def spectrum_monitor_gate(device=DEFAULT_DEVICE, rows: int = MONITOR_ROWS,
                          sample_rate: float = MONITOR_RATE_HZ, seed: int = 0) -> dict:
    """A capture of `rows` blocks made from `seed`, through the monitor on
    `device`. Returns ``ok``, the bars, the stage times, the launches of
    each hand-written kernel (and of the recursion by kind), the seconds end
    to end (the capture's upload to the bars' tensors; its numpy synthesis
    not), the planted bursts, the capture and the chain's outputs (tensors
    on `device`)."""
    device = resolve_device(device)
    host, planted = monitor_capture(rows, sample_rate, seed)
    inside_h, outside_h = _regions(planted, rows * MONITOR_BLOCK // MONITOR_DECIMATION,
                                   MONITOR_DECIMATION)
    inside, outside = torch.from_numpy(inside_h).to(device), torch.from_numpy(outside_h).to(device)
    before = launch_counts()
    kinds_before = dict(recurrence.first_order_recurrence.launches_by_kind)
    _synchronize(device)
    t0 = time.perf_counter()
    capture = torch.from_numpy(host).to(device)
    out = spectrum_monitor_chain(capture, sample_rate)
    values = _bar_tensors(out, inside, outside) if len(out["centres"]) == len(EMITTERS_HZ) else None
    _synchronize(device)
    total = time.perf_counter() - t0
    launches = _launched(before)
    launches["first_order_iir_by_kind"] = {
        k: v - kinds_before[k] for k, v in recurrence.first_order_recurrence.launches_by_kind.items()}
    if values is None:
        bars = {"ok": False, "centre_bins": out["centres"], "groups_ok": False}
    else:
        bars = monitor_bars(out, planted, sample_rate, values)
    return {"ok": bars["ok"], "bars": bars, "stage_ms": out["stage_ms"], "launches": launches,
            "seconds": total, "samples": int(host.size), "planted": planted, "capture": capture,
            "outputs": out, "device": str(device)}


def _ties(values: torch.Tensor, threshold) -> torch.Tensor:
    """Where `values` lies within TIE_REL of `threshold`, relative to it."""
    threshold = torch.as_tensor(threshold, dtype=values.dtype, device=values.device)
    return torch.abs(values - threshold) <= TIE_REL * torch.abs(threshold)


def monitor_agreement(card: dict, cpu: dict) -> dict:
    """A run on the card against a CPU run of the same capture: the centres
    equal; the burst decisions (`detect.burst_decisions` of each run's
    channels, on the CPU), masks and squelch gates equal but where a CPU
    value lies within TIE_REL of its threshold (a tie; a mask frame is
    excused while the latest tie is later than the latest decisive frame
    both runs agree on); the channels within DDC_TOL and the envelope and
    peak hold within SERIES_TOL of the largest CPU value. Returns ``ok``,
    the tie counts and the differences."""
    got = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in card.items()}
    res = {"centres_equal": got["centres"] == cpu["centres"]}
    if not res["centres_equal"]:
        return {**res, "ok": False}
    _, _, on_g, off_g = detect.burst_decisions(got["channels"], BURST_FRAME, BURST_ON_DB,
                                               BURST_OFF_DB)
    e, floor, on_c, off_c = detect.burst_decisions(cpu["channels"], BURST_FRAME, BURST_ON_DB,
                                                   BURST_OFF_DB)
    tie = _ties(e, floor + BURST_ON_DB) | _ties(e, floor + BURST_OFF_DB)
    same = (on_g == on_c) & (off_g == off_c)
    res["burst_ties"] = int(torch.sum(tie))
    res["decisions_equal"] = bool(torch.all(same | tie))
    steps = torch.arange(tie.shape[-1])
    _, last_tie = latest_set(tie, steps.expand(tie.shape))
    _, last_agreed = latest_set(same & (on_c | off_c) & ~tie, steps.expand(tie.shape))
    excused = last_tie > last_agreed
    res["mask_excused"] = int(torch.sum(excused & (got["mask"] != cpu["mask"])))
    res["masks_equal"] = bool(torch.all((got["mask"] == cpu["mask"]) | excused))
    res["edges_equal"] = all(
        all(np.array_equal(a, b) for a, b in zip(detect.burst_edges(gm), detect.burst_edges(cm)))
        for gm, cm in zip(got["mask"], cpu["mask"]))
    power, _ = sb.probe_avg_mag_sqrd(cpu["channels"], alpha=SQUELCH_ALPHA)
    sq_tie = _ties(power, float(np.float32(10.0 ** (SQUELCH_DB / 10.0))))
    gate_same = (got["squelched"] != 0) == (cpu["squelched"] != 0)
    res["squelch_ties"] = int(torch.sum(sq_tie))
    res["squelch_equal"] = bool(torch.all(gate_same | sq_tie))
    res["channels_rel"] = compare(got["channels"], cpu["channels"])
    res["envelope_rel"] = compare(got["envelope"], cpu["envelope"])
    res["peak_rel"] = compare(got["peak"], cpu["peak"])
    res["ok"] = (res["decisions_equal"] and res["masks_equal"] and res["squelch_equal"]
                 and (res["edges_equal"] or res["mask_excused"] > 0)
                 and res["channels_rel"] <= DDC_TOL and res["envelope_rel"] <= SERIES_TOL
                 and res["peak_rel"] <= SERIES_TOL)
    return res


# ------------------------------------------------------------ blocks gate

BLOCKS_TOL = 1e-5          # max|card − CPU| / max|CPU|: FFTs, sums and products in another order
BLOCKS_LOOP_TOL = 1e-4     # float32 step loops of matrix products (LMS, RLS, Kalman, UKF, lattice)
RECURSION_SHAPE = (4, MONITOR_BLOCK)  # the monitor's channels: each kind card = CPU, bit for bit
# each recursion kind's coefficients there: the monitor's and the filters' own
RECURSION_COEFS = {"linear": (0.995, 0.0), "one_pole": (0.05, 0.95), "ema": (SQUELCH_ALPHA, 0.0),
                   "attack_release": (0.2, 0.001), "peak_hold": (PEAK_DECAY, 0.0)}


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _cplx(rng, n) -> np.ndarray:
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _prbs9(n: int) -> np.ndarray:
    """tests/test_stream_blocks.py's PRBS9 stream (x^9 + x^5 + 1)."""
    taps, state, bits = (1 << 8) | (1 << 4), 0x1FF, []
    for _ in range(n):
        fb = bin(state & taps).count("1") & 1
        bits.append(fb)
        state = ((state << 1) | fb) & 0x1FF
    return np.asarray(bits, np.int32)


def _blocks_cases():
    """(name, function, numpy inputs as (args, kwargs), tolerance): the
    inputs of each function's JAX test."""
    tol, ltol = BLOCKS_TOL, BLOCKS_LOOP_TOL
    r = _rng(14)
    burst = _cplx(r, 8192) * np.float32(0.05 * np.sqrt(0.5))
    burst[1024:2048] += 2.0
    burst[5120:6144] += 2.0
    tone_n = np.arange(65536)
    sense = (_cplx(r, 65536) * np.float32(0.1 * np.sqrt(0.5))
             + np.exp(2j * np.pi * 0.1 * tone_n).astype(np.complex64))
    cusum = r.standard_normal(1000).astype(np.float32)
    cusum[600:] += 3.0
    word = np.asarray([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
    sync_bits = np.concatenate([np.zeros(37, np.int32), word, np.ones(20, np.int32)])
    sync_bits[40] ^= 1
    kurt = _cplx(r, 65536).reshape(-1, 256)
    kurt[::10] += 8.0 * np.exp(2j * np.pi * 40 / 256 * np.arange(256)).astype(np.complex64)
    vad = (0.02 * r.standard_normal(16384)).astype(np.float32)
    vad[4096:8192] += np.sin(2 * np.pi * 0.02 * np.arange(4096)).astype(np.float32)
    pcm = (8000 * np.sin(2 * np.pi * 0.01 * np.arange(2000))).astype(np.int32)
    x256 = _cplx(r, 256)
    fs = 10_000.0
    t = np.arange(8192) / fs
    xlat = (np.exp(2j * np.pi * 2000 * t) + np.exp(2j * np.pi * -3000 * t)).astype(np.complex64)
    templates = _cplx(r, (4, 64))
    mf = np.zeros(512, np.complex64)
    mf[100:164] = templates[2]
    syms = (2 * r.integers(0, 2, 256) - 1).astype(np.float32)
    rrc_tx = np.repeat(syms, 4).astype(np.complex64)
    gate_x = np.concatenate([np.full(300, 0.001), np.full(300, 1.0)]).astype(np.float32)
    comp_x = np.concatenate([np.full(2000, 0.05), np.full(2000, 1.0)]).astype(np.float32)
    impulse = _cplx(r, 1024) * np.float32(0.1)
    impulse[500] = 50.0
    squelch_x = np.concatenate([np.full(500, 0.01), np.full(3000, 1.0),
                                np.full(500, 0.01)]).astype(np.complex64)
    env_x = np.concatenate([np.ones(200), np.zeros(800)]).astype(np.float32)
    lms_x = r.standard_normal(4000).astype(np.float32)
    lms_d = np.convolve(lms_x, [0.8, -0.4, 0.2, 0.1])[:4000].astype(np.float32)
    rls_x = _cplx(r, 1500)
    rls_d = np.convolve(rls_x, [0.7 + 0.3j, -0.2 + 0.5j, 0.1 - 0.1j])[:1500].astype(np.complex64)
    notch = (2.0 * np.exp(2j * np.pi * 0.123 * np.arange(6000)) + 0.3 * _cplx(r, 6000)).astype(
        np.complex64)
    pa_x = (_cplx(r, 3000) * 0.3).astype(np.complex64)
    pa_c = np.zeros((3, 3), np.complex64)
    pa_c[0, 0], pa_c[1, 0], pa_c[0, 1] = 1.0, -0.1 + 0.05j, 0.08j
    key = threefry.key(0)
    return [
        # stream_math (tests/test_detect_streammath.py::TestStreamMath)
        ("stream_math.complex_to_mag_phase", sm.complex_to_mag_phase, ((x256,), {}), tol),
        ("stream_math.mag_phase_to_complex", lambda m, p: sm.mag_phase_to_complex(m, p),
         ((np.abs(x256), np.angle(x256)), {}), tol),
        ("stream_math.normalize_conjugate_arg", lambda x: (
            sm.complex_normalize(x), sm.stream_conjugate(x), sm.complex_to_arg(x),
            sm.stream_abs(x)), ((x256,), {}), tol),
        ("stream_math.interleaved", lambda x: sm.interleaved_to_complex(
            sm.complex_to_interleaved(x)), ((x256,), {}), tol),
        ("stream_math.char", lambda x: (sm.float_to_char(x), sm.char_to_float(
            sm.float_to_char(x))), ((r.uniform(-1.2, 1.2, 100),), {}), tol),
        ("stream_math.arithmetic", lambda a, b: (sm.stream_add(a, b, a), sm.stream_multiply(a, b),
                                                 sm.argmax_block(a), sm.bin_statistics(a, 3)),
         ((np.arange(12, dtype=np.float32), r.standard_normal(12)), {}), tol),
        ("stream_math.threshold_block", lambda x: (sm.threshold_block(x, 0.5, 1.0),
                                                   sm.threshold_block(x, 0.5)),
         ((np.asarray([0.0, 0.9, 1.1, 0.7, 0.3, 1.2, 0.0]),), {}), tol),
        ("stream_math.signal_clipper", lambda c, x: (sm.signal_clipper(c, 1.0),
                                                     sm.signal_clipper(x, 0.5)),
         ((np.asarray([3 + 4j, 0.1 + 0.1j], np.complex64), r.standard_normal(64)), {}), tol),
        ("stream_math.bits", lambda b: (sm.binary_slicer(b - 0.5), sm.unpack_bits(
            sm.pack_bits(b, 8), 8), sm.pack_bits(b, 8, msb_first=False)),
         ((r.integers(0, 2, 64),), {}), tol),
        ("stream_math.uniform_quantize", lambda x: sm.uniform_quantize(x, 8),
         ((r.uniform(-1, 1, 100_000),), {}), tol),
        ("stream_math.sigma_delta_modulate", sm.sigma_delta_modulate,
         ((np.full(4096, 0.25),), {}), tol),
        ("stream_math.mu_law", lambda x: sm.mu_law_decode(sm.mu_law_encode(x)),
         ((np.linspace(-1, 1, 101),), {}), tol),
        ("stream_math.adpcm", lambda p: (sm.adpcm_encode(p), sm.adpcm_decode(sm.adpcm_encode(p)[0])),
         ((pcm,), {}), tol),
        ("stream_math.burst_shape", lambda x: sm.burst_shape(x, ramp=128),
         ((np.exp(2j * np.pi * 0.1 * np.arange(2048)).astype(np.complex64),), {}), tol),
        # detect (tests/test_detect_streammath.py::TestDetectors)
        ("detect.energy_detect", lambda x: detect.energy_detect(x, frame=256), ((burst,), {}), tol),
        ("detect.burst_detect", lambda x: (detect.burst_detect(x, frame=64), detect.squelch(
            x, frame=64)), ((burst,), {}), tol),
        ("detect.zero_crossing_rate", detect.zero_crossing_rate,
         ((np.sin(2 * np.pi * 0.45 * np.arange(4096)),), {}), tol),
        ("detect.voice_activity", lambda a: detect.voice_activity(a, 256), ((vad,), {}), tol),
        ("detect.sync_word", lambda b, w: (detect.sync_word_correlate(b, w),
                                           detect.sync_word_detect(b, w, max_errors=1)),
         ((sync_bits, word), {}), tol),
        ("detect.teager_kaiser", detect.teager_kaiser, ((2.0 * np.cos(0.3 * np.arange(2048)),), {}),
         tol),
        ("detect.spectral_kurtosis", lambda x: detect.spectral_kurtosis(x, 256),
         ((kurt.reshape(-1),), {}), tol),
        ("detect.spectrum_sense", lambda x: detect.spectrum_sense(x, nfft=256), ((sense,), {}), tol),
        ("detect.cusum_changepoint", detect.cusum_changepoint, ((cusum,), {}), tol),
        # filters2 (tests/test_filters2.py)
        ("filters2.overlap_save", lambda x, h: filters2.overlap_save(x, h),
         ((_cplx(r, 1000), r.standard_normal(31)), {}), tol),
        ("filters2.overlap_add", lambda x, h: filters2.overlap_add(x, h, block=128),
         ((r.standard_normal(777), r.standard_normal(32)), {}), tol),
        ("filters2.frequency_xlating_fft_filter", lambda x: filters2.frequency_xlating_fft_filter(
            x, filters2.filter_synthesis("lowpass", 101, fs, 500.0), 2000.0, fs, decim=4),
         ((xlat,), {}), tol),
        ("filters2.matched_filter_bank", filters2.matched_filter_bank, ((mf, templates), {}), tol),
        ("filters2.rrc_matched_filter_bank", lambda x: filters2.rrc_matched_filter_bank(
            x, 4, rolloffs=(0.1, 0.35, 0.9)), ((rrc_tx,), {}), tol),
        ("filters2.sparse_fir_filter", lambda x: filters2.sparse_fir_filter(x, [1.0, 0.5], [0, 2]),
         ((np.arange(10, dtype=np.float32),), {}), tol),
        ("filters2.interpolators", lambda x: (filters2.lagrange_interpolate(x, 0.5, order=3),
                                              filters2.mmse_interpolate(x, 0.5, n_taps=8)),
         ((np.cos(2 * np.pi * 5 * np.arange(256) / 100.0),), {}), tol),
        ("filters2.interpolating_resampler", lambda x: filters2.interpolating_resampler(x, 2.0),
         ((np.exp(2j * np.pi * 100 * np.arange(2048) / 1000.0).astype(np.complex64),), {}), tol),
        ("filters2.sample_rate_converter", lambda x: (filters2.sample_rate_converter(
            x, 48_000.0, 24_000.0), filters2.sample_rate_converter(x, 48_000.0, 24_000.0 / 1.0007)),
         ((_cplx(r, 1000),), {}), tol),
        ("filters2.digital_up_converter", lambda x: filters2.digital_up_converter(
            x, 4, 2000.0, 8000.0), ((np.ones(256, np.complex64),), {}), tol),
        ("filters2.variable_rate_cic", lambda x: (filters2.variable_rate_cic(x, 4, 3, interp=True),
                                                  filters2.variable_rate_cic(x, 4, 3)),
         ((np.ones(64, np.float32),), {}), tol),
        # a tone in noise: on a bare tone the other bins hold only rounding
        ("filters2.spectral", lambda x: (
            filters2.log_power_fft(x, nfft=1024), filters2.frequency_domain_oversampled_dft(
                x[..., :128], 128, oversample=8), filters2.welch_periodogram(x, nfft=256),
            filters2.instantaneous_frequency(x, 1024.0)),
         (((np.exp(2j * np.pi * 128 * np.arange(4096) / 1024.0) + 0.1 * _cplx(r, 4096))
           .astype(np.complex64),), {}), tol),
        ("filters2.noise_blanker", filters2.noise_blanker, ((impulse,), {}), tol),
        ("filters2.noise_gate", lambda x: filters2.noise_gate(x, open_db=-20.0), ((gate_x,), {}),
         tol),
        ("filters2.noise_shaping_quantize", lambda x: (filters2.noise_shaping_quantize(x, 4),
                                                       filters2.noise_shaping_quantize(x, 4, 2)),
         ((0.5 * np.sin(2 * np.pi * 0.01 * np.arange(8192)),), {}), tol),
        ("filters2.compressors", lambda x, y: (
            filters2.dynamic_range_compressor(x, threshold_db=-20.0, ratio=4.0),
            filters2.multiband_compressor(y, 48_000.0)),
         ((comp_x, r.standard_normal(4096)), {}), tol),
        # stream_blocks (tests/test_stream_blocks.py)
        ("stream_blocks.probes", lambda x, b: (sb.probe_avg_mag_sqrd(x, alpha=0.01),
                                               sb.probe_power(x), sb.probe_density(b, alpha=0.01)),
         ((np.full(4000, 2.0 + 0j, np.complex64), np.tile([1, 0], 2000)), {}), tol),
        ("stream_blocks.peaks", lambda x, g: (sb.peak_detector(x, threshold=1.0), sb.peak_hold(
            x, decay=0.9), sb.plateau_detector(g, min_len=8)),
         ((np.where(np.arange(64) == 20, 5.0, 0.0).astype(np.float32),
           np.isin(np.arange(40), list(range(5, 15)) + [20, 21, 22]).astype(np.int32)), {}), tol),
        ("stream_blocks.sample_and_hold", lambda x, c: (sb.sample_and_hold(x, c),
                                                        sb.sample_counter(x, state=50)),
         ((np.arange(8.0), np.asarray([1, 0, 0, 1, 0, 0, 1, 0])), {}), tol),
        ("stream_blocks.rates", lambda x: (sb.integrate_and_dump(x, 4), sb.keep_m_in_n(x, 2, 4, 1),
                                           sb.moving_avg_decim(x, 4, 2), sb.stretch(x, 5.0),
                                           sb.mute(x, 1.0)),
         ((np.arange(64, dtype=np.float32),), {}), tol),
        ("stream_blocks.power_squelch", lambda x: sb.power_squelch(x, -10.0, alpha=0.05),
         ((squelch_x,), {}), tol),
        ("stream_blocks.envelope_detector", lambda x: sb.envelope_detector(x, 0.5, 0.01),
         ((env_x,), {}), tol),
        ("stream_blocks.random_source", lambda x: tuple(
            sb.random_source(key, 256, kind, device=x.device)
            for kind in ("uniform_byte", "bits", "uniform", "gaussian")), ((np.zeros(1),), {}), tol),
        ("stream_blocks.sources", lambda x: (
            sb.signal_source(1000, 1000.0, 100.0, "exp", device=x.device),
            sb.signal_source(1000, 1000.0, 100.0, "square", device=x.device),
            sb.signal_source(1000, 1000.0, 100.0, "triangle", device=x.device),
            sb.signal_generator_sweep(4096, 4096.0, 100.0, 900.0, device=x.device),
            sb.vector_insert(x, np.ones(2), period=4), sb.null_source(64, device=x.device)),
         ((np.zeros(8, np.float32),), {}), tol),
        ("stream_blocks.scalar_math", lambda x: (
            sb.magnitude_squared(x + 1j), sb.nlog10(x + 1.0), sb.log_block(x + 1.0, 2.0),
            sb.max_block(x, -x), sb.exponentiate(x, 3), sb.transcendental(x, "cos")),
         ((r.standard_normal(64),), {}), tol),
        ("stream_blocks.phase_mix", lambda x, p: (
            sb.phase_shift(x, np.pi / 2), sb.phase_unwrap(p), sb.phase_wrap(p),
            sb.frequency_shift(x, 100.0, 1000.0), sb.rf_mixer(x, x, "real"), sb.rf_mixer(x, x)),
         ((_cplx(r, 2048), np.cumsum(r.uniform(0, 3, 64)) % (2 * np.pi)), {}), tol),
        ("stream_blocks.matrices", lambda a, x: (
            sb.multiply_matrix(x, a), sb.matrix_eigenvalue(a + a.T),
            sb.matrix_eigenvalue(a + a.T, hermitian=False)),
         ((np.asarray([[2.0, 1.0], [0.0, 5.0]]), r.standard_normal((16, 2))), {}), tol),
        ("stream_blocks.bits", lambda w, b: (
            sb.endian_swap(w, 16), sb.endian_swap(w, 32), sb.bitwise_op(w, w >> 1, "xor"),
            sb.float_to_short(sb.short_to_float(w)), sb.float_to_complex(w, w),
            sb.repack_bits(sb.repack_bits(w & 0xFF, 8, 4), 4, 8), sb.check_lfsr(b, 0x110, 9)),
         ((r.integers(0, 1 << 15, 16).astype(np.int32), _prbs9(600)), {}), tol),
        ("stream_blocks.streams", lambda x: (sb.stream_switch([x, -x], 1), sb.streams_to_stream(
            sb.stream_to_streams(x, 3))), ((np.arange(12, dtype=np.float32),), {}), tol),
        # adaptive (tests/test_adaptive_kalman.py)
        ("adaptive.lms_filter", lambda x, d: adaptive.lms_filter(x, d, num_taps=4, mu=0.5),
         ((lms_x, lms_d), {}), ltol),
        ("adaptive.rls_filter", lambda x, d: adaptive.rls_filter(x, d, num_taps=3, lam=0.995),
         ((rls_x, rls_d), {}), ltol),
        ("adaptive.adaptive_notch", lambda x: adaptive.adaptive_notch(x[:1500], 32, 0.05),
         ((notch,), {}), ltol),
        ("adaptive.savgol_wiener", lambda x, c: (
            adaptive.savgol_smooth(x, 21, 3), adaptive.wiener_filter(c, 0.5, 256)),
         ((r.standard_normal(400), _cplx(r, 4096)), {}), tol),
        ("adaptive.lattice_filter", lambda x: adaptive.lattice_filter(
            adaptive.lattice_from_lpc([1.0, -0.5, 0.25]), x), ((r.standard_normal(128),), {}), ltol),
        ("adaptive.combs", lambda x: (adaptive.comb_feedforward(x, 8), adaptive.comb_feedback(
            x, 4, 0.5), adaptive.comb_feedback(x, 7, 0.9)), ((r.standard_normal(1024),), {}), tol),
        ("adaptive.memory_polynomial", lambda c, x: (
            adaptive.memory_polynomial_apply(c, x), adaptive.identify_memory_polynomial(
                x, adaptive.memory_polynomial_apply(c, x), memory=3),
            adaptive.am_am_curve(x, adaptive.memory_polynomial_apply(c, x), 16)),
         ((pa_c, pa_x), {}), ltol),
        ("adaptive.fft_filter", adaptive.fft_filter, ((r.standard_normal(63), _cplx(r, 1000)), {}),
         tol),
        # kalman (tests/test_adaptive_kalman.py)
        ("kalman.kalman_filter", lambda z: (
            kalman.kalman_filter(kalman.KalmanParams.scalar(1e-5, 0.25, device=z.device), z),
            kalman.kalman_filter(kalman.KalmanParams.constant_velocity(
                0.1, 1e-2, 0.25, device=z.device), z)),
         ((1.0 + 0.5 * r.standard_normal(200),), {}), ltol),
        ("kalman.ukf_filter", lambda z: kalman.ukf_filter(
            lambda x: x, lambda x: x * x, 1e-6 * np.eye(1), 0.25 * np.eye(1), z,
            np.asarray([2.0]), np.eye(1), device=z.device),
         ((9.0 + 0.5 * r.standard_normal(150),), {}), ltol),
    ]


def recursion_kinds_card_vs_cpu(device, shape=RECURSION_SHAPE, seed: int = 44) -> dict:
    """Each recursion kind on `device` against the plain version on the CPU
    at `shape`, bit for bit: the number of differing samples by kind."""
    u = np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    got = torch.from_numpy(u).to(device)
    want = torch.from_numpy(u)
    return {kind: int(torch.sum(recurrence.first_order_recurrence_dispatch(got, kind, *c).cpu()
                                != recurrence.first_order_recurrence(want, kind, *c)))
            for kind, c in RECURSION_COEFS.items()}


def dsp_blocks_gate(device=DEFAULT_DEVICE, recursion_shape=RECURSION_SHAPE) -> dict:
    """Every case of `_blocks_cases` on `device` and on the CPU (the worst
    difference a case, inf for differing decisions; each held to its
    tolerance), then each recursion kind card = CPU at `recursion_shape`.
    Returns ``ok``, ``worst`` by case, ``failed`` and ``recursion_diffs``."""
    device = resolve_device(device)
    cpu = torch.device("cpu")
    worst, failed = {}, []
    for name, fn, (args, kwargs), tol in _blocks_cases():
        got = fn(*_on(list(args), device), **kwargs)
        want = fn(*_on(list(args), cpu), **kwargs)
        worst[name] = compare(got, want)
        if not worst[name] <= tol:
            failed.append(name)
    diffs = recursion_kinds_card_vs_cpu(device, recursion_shape)
    ok = not failed and not any(diffs.values())
    return {"ok": ok, "worst": worst, "failed": failed, "recursion_diffs": diffs,
            "recursion_shape": list(recursion_shape), "device": str(device)}
