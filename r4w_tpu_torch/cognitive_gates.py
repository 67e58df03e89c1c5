"""The spectrum-analysis, cognitive-radio, instruments and sensing slice's
two gates: a dynamic-spectrum-access (DSA) node's sensing cycle at full
width, and the slice's blocks card against CPU.

`spectrum_access_gate(device, rows, block)` builds a 20 MHz band at
30.72 MS/s in numpy from seed 0 (`dsa_scene`): unit-power complex AWGN;
an OFDM-like carrier over channels 2-5 of 16 (QPSK on every bin of
1024-sample symbols, 10 dB in band, always on); two push-to-talk FM
emitters in channels 8 and 11 (keyed as the spectrum monitor's, 15 dB in
channel); a 480 kbaud rectangular BPSK in channel 13 at −5 dB in channel,
which a 6 dB energy detector misses; and a CW interferer 100 kHz above
channel 6's centre, +4.1 dB on that channel. It uploads the (rows, 2^20)
blocks once and runs the DSA cycle (`spectrum_access_chain`) of the port's
functions:

1. Sense: `cognitive.channel_occupancy` and `coexistence_report` on every
   block, a `CognitiveEngine(16)` step a block, the band's waterfall
   (`analysis.Waterfall`, 1024 bins, no overlap) with
   `spectral2.waterfall_enhance` and `spectrogram_anomaly_score`.
2. Detect: every channel idle in every block is down-converted
   (`stream_math.digital_down_convert` by 16 on the blocks: one `nco_mix`
   and one `fir_decimate` launch a channel); `cyclic_autocorrelation` at
   α = 0.25 (the BPSK's symbol rate) and an off-feature α, a block at a
   time, averaged over the blocks; `spectral_entropy`; and
   `interference_classify` on the first block.
3. Decide: channels busy in any block and channels whose feature crosses
   FEATURE_THRESHOLD are leased to "incumbent"; `SpectrumBroker.request`
   grants three secondary users the cleanest free channels, and
   `link_adapt` picks each user's MCS from its channel's SNR estimate.
4. Clean: `interference_excise` on the channel classified "tone".
5. Self-check (`self_check`): the node's QPSK burst at the first user's
   MCS, shaped by `pulse.root_raised_cosine_taps` (two FIR launches, the
   shaping and the matched filter), with a spur at −50 dBc; `spur_scan`
   on the burst outside its band finds the spur, and `spur_level_dbc`
   measures it on the burst against the burst's power; the burst through
   `vector_signal_analyze`, `power_meter_dbm`, `lpi_metrics`, and
   `analysis.SpectrumAnalyzer` into `mask_compliance` against SELF_MASK.

`access_bars` holds the result to the scene's truth; `access_agreement`
holds a card run against a CPU run of the same blocks, and
`waterfall_agreement` the full-size waterfall stage against the CPU.

`sensing_blocks_gate(device)` runs every `BLOCKS` entry of `spectral2`,
`cognitive`, `instruments` and `sensing` and both `analysis` classes on
their JAX tests' inputs on `device` and on the CPU: decisions equal,
floats within the stated tolerance, the worst case by name.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from r4w_tpu_torch import analysis
from r4w_tpu_torch.core.hostio import complex_abs
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, resolve_device
from r4w_tpu_torch.modem_gates import _Stages, _launched, _on, _synchronize, compare, launch_counts
from r4w_tpu_torch.monitor_gates import EMITTER_DEVIATION_HZ, EMITTER_TONE_HZ, _bursts
from r4w_tpu_torch.ops import cognitive as cg
from r4w_tpu_torch.ops import instruments as inst
from r4w_tpu_torch.ops import mapping, pulse
from r4w_tpu_torch.ops import sensing as sn
from r4w_tpu_torch.ops import spectral2 as sp2
from r4w_tpu_torch.ops.stream_math import digital_down_convert

DSA_RATE_HZ = 30.72e6               # a 20 MHz SDR capture
DSA_BLOCK = 1 << 20                 # samples a block (34.1 ms)
DSA_ROWS = 32                       # 1.092 s, 268 MB of complex64
N_CHANNELS = 16                     # 1.92 MHz channels over the fftshifted band
OCCUPANCY_NFFT, OCCUPANCY_DB = 1024, 6.0
OFDM_CHANNELS, OFDM_SNR_DB, OFDM_NFFT = (2, 3, 4, 5), 10.0, 1024
FM_CHANNELS, FM_SNR_DB = (8, 11), 15.0
BPSK_CHANNEL, BPSK_BAUD, BPSK_SNR_DB = 13, 480e3, -5.0
TONE_CHANNEL, TONE_OFFSET_HZ, TONE_POWER = 6, 100e3, 0.1
DDC_DECIMATION = 16                 # 1.92 MS/s channels
FEATURE_ALPHA, OFF_ALPHA, FEATURE_LAGS = 0.25, 0.123, 4
FEATURE_THRESHOLD = 2e-3            # max over lags of |R_0.25(τ)| averaged over the blocks
ENTROPY_NFFT = 256
EXCISE_SIGMA, EXCISE_NFFT = 4.0, 1024
WATERFALL_NFFT = 1024
ANOMALY_TRAIN = 16
USERS = ("su1", "su2", "su3")
LINK_MARGIN_DB = 8.0                # a user's SNR on a clean channel: QPSK 3/4
ENGINE_SNR_DB = LINK_MARGIN_DB
# bars
DUTY_TOL = 0.02
KEYED_BUSY_S = 5e-3                 # a block where an emitter keys this long must read busy
EXCISE_DROP_DB, EXCISE_MEDIAN_DB = 20.0, 0.5
SPUR_DBC_TOL, EVM_REL_TOL = 1.0, 0.10
# card against CPU
TIE_REL = 1e-5                      # a decision within this of its threshold (relative) is a tie
FLOAT_TOL = 1e-4                    # features, entropies, occupancy dB: max|Δ| over max|CPU|
CHANNEL_TOL = 1e-5                  # the down-converted channels
CARD_CPU_ROWS = 4
# self-check: the node's burst on a 1.92 MS/s channel
SELF_RATE_HZ = DSA_RATE_HZ / DDC_DECIMATION
SELF_SPS, SELF_SYMBOLS, SELF_ROLLOFF, SELF_SPAN = 8, 4096, 0.35, 8
SELF_SNR_DB, SELF_SEED = 30.0, 1
SPUR_DBC, SPUR_HZ = -50.0, 500e3
SPUR_EXCLUDE_HZ = 240e3             # the scan skips the burst's band and skirt (SELF_MASK)
SPUR_BAND_BINS = 3                  # the spur's power: ±3 bins of the burst's Hann periodogram
SELF_PSD_NFFT = 1024
# the burst's PSD relative to its peak: +1 dB over the RRC band (162 kHz),
# −25 dB from 240 kHz to the channel's edge
SELF_MASK = ((0.0, 1.0), (162e3, 1.0), (240e3, -25.0), (960e3, -25.0))


def channel_centre_hz(c: int) -> float:
    """Channel c's centre: −fs/2 + (c + ½)·fs/16 at DSA_RATE_HZ."""
    return -DSA_RATE_HZ / 2 + (c + 0.5) * DSA_RATE_HZ / N_CHANNELS


def _cn(rng: np.random.Generator, n: int) -> np.ndarray:
    return ((rng.standard_normal(n, dtype=np.float32) + 1j * rng.standard_normal(
        n, dtype=np.float32)) * np.float32(np.sqrt(0.5))).astype(np.complex64)


def dsa_scene(rows: int = DSA_ROWS, block: int = DSA_BLOCK):
    """(capture (rows, block) complex64, truth): the band at DSA_RATE_HZ made
    in numpy from seed 0, block by block (phases in float64). `truth` holds
    each FM emitter's bursts as [start, stop) samples and its planted duty.
    The scene's levels, bursts and offsets are in fixed Hz and samples, and
    FEATURE_ALPHA is the BPSK's symbol rate at that rate over
    DDC_DECIMATION, so the rate is not a parameter."""
    sample_rate = DSA_RATE_HZ
    n = rows * block
    rng = np.random.default_rng(0)
    noise_ch = 1.0 / N_CHANNELS                      # unit noise over 16 channels
    per = OFDM_NFFT // N_CHANNELS
    shifted = np.arange(OFDM_CHANNELS[0] * per, (OFDM_CHANNELS[-1] + 1) * per)
    ofdm_bins = (shifted + OFDM_NFFT // 2) % OFDM_NFFT
    ofdm_amp = math.sqrt(10.0 ** (OFDM_SNR_DB / 10.0) * OFDM_NFFT)
    fm_amp = math.sqrt(10.0 ** (FM_SNR_DB / 10.0) * noise_ch)
    bursts = {c: _bursts(rng, n, sample_rate) for c in FM_CHANNELS}
    fm_phase0 = {c: rng.uniform(0.0, 2.0 * np.pi) for c in FM_CHANNELS}
    sps = int(round(sample_rate / BPSK_BAUD))
    bpsk_syms = (2.0 * rng.integers(0, 2, -(-n // sps)) - 1.0).astype(np.float32)
    bpsk_amp = math.sqrt(10.0 ** (BPSK_SNR_DB / 10.0) * noise_ch)
    bpsk_f = channel_centre_hz(BPSK_CHANNEL) / sample_rate
    bpsk_phase0 = rng.uniform(0.0, 2.0 * np.pi)
    tone_f = (channel_centre_hz(TONE_CHANNEL) + TONE_OFFSET_HZ) / sample_rate
    tone_phase0 = rng.uniform(0.0, 2.0 * np.pi)
    cap = np.empty((rows, block), np.complex64)
    for r in range(rows):
        k = np.arange(r * block, (r + 1) * block)
        blk = _cn(rng, block).astype(np.complex128)
        n_sym = block // OFDM_NFFT
        spec = np.zeros((n_sym, OFDM_NFFT), np.complex128)
        spec[:, ofdm_bins] = ofdm_amp * np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(
            0, 4, (n_sym, ofdm_bins.size))))
        blk[: n_sym * OFDM_NFFT] += np.fft.ifft(spec, axis=-1).reshape(-1)
        blk += bpsk_amp * bpsk_syms[k // sps] * np.exp(1j * (2 * np.pi * ((k * bpsk_f) % 1.0)
                                                            + bpsk_phase0))
        blk += math.sqrt(TONE_POWER) * np.exp(1j * (2 * np.pi * ((k * tone_f) % 1.0)
                                                    + tone_phase0))
        for c in FM_CHANNELS:
            f_c = channel_centre_hz(c)
            for start, stop in bursts[c]:
                a, b = max(start, r * block), min(stop, (r + 1) * block)
                if a >= b:
                    continue
                t = np.arange(a, b) / sample_rate
                phase = (fm_phase0[c] + 2 * np.pi * f_c * t + EMITTER_DEVIATION_HZ
                         / EMITTER_TONE_HZ * np.sin(2 * np.pi * EMITTER_TONE_HZ * t))
                blk[a - r * block:b - r * block] += fm_amp * np.exp(1j * phase)
        cap[r] = blk
    duty = {c: sum(b - a for a, b in bursts[c]) / n for c in FM_CHANNELS}
    return cap, {"bursts": bursts, "duty": duty, "rows": rows, "block": block}


def _keyed_samples(bursts, rows: int, block: int) -> np.ndarray:
    """(rows,) samples a block that an emitter's bursts cover."""
    out = np.zeros(rows, np.int64)
    for start, stop in bursts:
        for r in range(start // block, min((stop - 1) // block, rows - 1) + 1):
            out[r] += min(stop, (r + 1) * block) - max(start, r * block)
    return out


def _psd(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Mean |FFT|² over the n_fft frames of every row."""
    frames = x[..., : (x.shape[-1] // n_fft) * n_fft].reshape(-1, n_fft)
    return torch.mean(complex_abs(torch.fft.fft(frames, dim=-1)) ** 2, dim=0)


def spectrum_access_chain(capture: torch.Tensor) -> dict:
    """The DSA cycle on (rows, block) blocks at DSA_RATE_HZ, each stage's
    milliseconds (CUDA events on the card) in ``stage_ms``."""
    sample_rate = DSA_RATE_HZ
    dev = capture.device
    rows = capture.shape[0]
    stages = _Stages(dev)
    stages.mark("start")
    busy, ch_db = cg.channel_occupancy(capture, N_CHANNELS, OCCUPANCY_NFFT, OCCUPANCY_DB)
    duty, duty_db = cg.coexistence_report(capture, N_CHANNELS)
    stages.mark("occupancy")
    engine = cg.CognitiveEngine(N_CHANNELS)
    picks = [engine.step(capture[r], ENGINE_SNR_DB)["channel"] for r in range(rows)]
    stages.mark("engine")
    wf = analysis.Waterfall(sample_rate, WATERFALL_NFFT, WATERFALL_NFFT).power_db(
        capture.reshape(-1))
    enhanced = sp2.waterfall_enhance(wf)
    anomaly = sp2.spectrogram_anomaly_score(wf, ANOMALY_TRAIN)
    stages.mark("waterfall")
    busy_h = busy.cpu().numpy()
    candidates = [c for c in range(N_CHANNELS) if not busy_h[:, c].any()]
    chans = torch.stack([digital_down_convert(capture, channel_centre_hz(c),
                                              sample_rate, DDC_DECIMATION) for c in candidates])
    stages.mark("digital_down_convert")
    caf = sp2.cyclic_autocorrelation(chans, [FEATURE_ALPHA, OFF_ALPHA], FEATURE_LAGS)
    feat = complex_abs(torch.mean(caf, dim=1))             # (C, 2, lags)
    stat, off = torch.amax(feat[:, 0], dim=-1), torch.amax(feat[:, 1], dim=-1)
    stages.mark("cyclic_autocorrelation")
    entropy = sp2.spectral_entropy(chans.reshape(len(candidates), -1), ENTROPY_NFFT)
    labels = [cg.interference_classify(chans[i, 0], sample_rate / DDC_DECIMATION)
              for i in range(len(candidates))]
    stages.mark("classify")
    stat_h = stat.cpu().numpy()
    flagged = [c for c, s in zip(candidates, stat_h) if s > FEATURE_THRESHOLD]
    broker = cg.SpectrumBroker(N_CHANNELS)
    for c in sorted(set(np.flatnonzero(busy_h.any(axis=0)).tolist()) | set(flagged)):
        broker.leases[c] = "incumbent"
    mean_db = torch.mean(ch_db, dim=0).cpu().numpy()
    floor_db = float(np.median(mean_db))
    grants, mcs = {}, {}
    for user in USERS:
        c = broker.request(user, mean_db)
        grants[user] = c
        mcs[user] = None if c is None else cg.link_adapt(
            LINK_MARGIN_DB - (float(mean_db[c]) - floor_db))
    stages.mark("decide")
    tones = [c for c, lab in zip(candidates, labels) if lab == "tone"]
    excision = {}
    for c in tones:
        x = chans[candidates.index(c)]
        clean = cg.interference_excise(x, EXCISE_SIGMA, EXCISE_NFFT)
        before, after = _psd(x, EXCISE_NFFT), _psd(clean, EXCISE_NFFT)
        k = torch.argmax(before)
        excision[c] = {"tone_bin": k, "drop_db": 10.0 * torch.log10(before[k] / after[k]),
                       "median_shift_db": 10.0 * torch.log10(sp2.median(after)
                                                             / sp2.median(before)),
                       "clean": clean}
    stages.mark("excise")
    return {"busy": busy, "ch_db": ch_db, "duty": duty, "duty_db": duty_db, "picks": picks,
            "p_idle": engine.learner.p_idle.copy(), "waterfall": wf, "enhanced": enhanced,
            "anomaly": anomaly, "candidates": candidates,
            "channels": chans, "caf": caf, "feature": stat, "off_feature": off,
            "entropy": entropy, "labels": labels, "flagged": flagged,
            "leases": dict(broker.leases), "grants": grants, "mcs": mcs, "tones": tones,
            "excision": excision, "stage_ms": stages.ms()}


def _qpsk(device) -> torch.Tensor:
    return mapping.constellation_table("qpsk", device)


def spur_level_dbc(x: torch.Tensor, spur_hz: float) -> torch.Tensor:
    """A spur's power against the whole burst's, in dB: the Hann-windowed
    periodogram of `x` summed over SPUR_BAND_BINS bins either side of
    `spur_hz` (the window's main lobe and more), over its sum. The noise in
    those bins lies some 17 dB under a −50 dBc spur at this length."""
    n = x.shape[-1]
    w = torch.from_numpy(np.hanning(n).astype(np.float32)).to(x.device)
    spec = complex_abs(torch.fft.fft(x * w)) ** 2
    k = int(round(spur_hz * n / SELF_RATE_HZ))
    idx = torch.arange(k - SPUR_BAND_BINS, k + SPUR_BAND_BINS + 1, device=x.device) % n
    return 10.0 * torch.log10(torch.sum(spec[idx]) / torch.sum(spec))


def self_check(mcs_index: int, device) -> dict:
    """The node's transmitter against itself: a QPSK burst of SELF_SYMBOLS
    at SELF_SPS samples a symbol (root-raised-cosine, rolloff SELF_ROLLOFF,
    unit power) with a spur SPUR_DBC under the burst at SPUR_HZ and AWGN at
    SELF_SNR_DB, drawn from SELF_SEED. `spur_scan` on the burst outside
    ±SPUR_EXCLUDE_HZ finds the spur (its dBc there is against the burst's
    DC bin), and `spur_level_dbc` measures it against the burst's power.
    Returns the measurements (tensors on `device`)."""
    device = resolve_device(device)
    rng = np.random.default_rng(SELF_SEED)
    info = cg.mcs_info(mcs_index)
    table = _qpsk(device)
    idx = torch.from_numpy(rng.integers(0, 4, SELF_SYMBOLS)).to(device)
    taps = pulse.root_raised_cosine_taps(SELF_SPS, SELF_SPAN, SELF_ROLLOFF)
    burst = pulse.shape_symbols(table[idx], taps, SELF_SPS) * math.sqrt(SELF_SPS)
    n = burst.shape[-1]
    t = np.arange(n) / SELF_RATE_HZ
    impair = (10.0 ** (SPUR_DBC / 20.0) * np.exp(2j * np.pi * SPUR_HZ * t)
              + 10.0 ** (-SELF_SNR_DB / 20.0) * _cn(rng, n)).astype(np.complex64)
    burst = burst + torch.from_numpy(impair).to(device)
    freqs, dbc, valid = inst.spur_scan(burst, SELF_RATE_HZ, 0.0, exclude_hz=SPUR_EXCLUDE_HZ,
                                       threshold_dbc=-70.0, max_spurs=4)
    level = spur_level_dbc(burst, float(freqs[0]))
    delay = (len(taps) - 1) // 2
    rx = pulse.matched_filter(burst, taps)[delay::SELF_SPS][:SELF_SYMBOLS] / math.sqrt(SELF_SPS)
    vsa = inst.vector_signal_analyze(rx, table, 1)
    p_avg, p_peak = inst.power_meter_dbm(burst)
    lpi = cg.lpi_metrics(burst)
    spec = analysis.SpectrumAnalyzer(SELF_RATE_HZ, SELF_PSD_NFFT).compute(burst, n_peaks=1)
    rel_db = spec.psd_db - np.max(spec.psd_db)
    ok, margin = cg.mask_compliance(torch.from_numpy(rel_db.astype(np.float32)),
                                    torch.from_numpy(spec.freqs_hz.astype(np.float32)), SELF_MASK)
    return {"mcs": info["name"], "spur_hz": SPUR_HZ, "scan_hz": freqs, "scan_dbc": dbc,
            "scan_valid": valid, "spur_level_dbc": level, "vsa": vsa,
            "power_dbm": (p_avg, p_peak), "lpi": lpi, "psd_db": spec.psd_db,
            "mask_ok": bool(ok), "mask_margin_db": float(margin), "burst": burst}


def self_check_bars(sc: dict) -> dict:
    """The spur found on the burst at its frequency within one bin of the
    burst's periodogram and at SPUR_DBC within SPUR_DBC_TOL of the burst's
    power; the burst inside SELF_MASK."""
    bin_hz = SELF_RATE_HZ / sc["burst"].shape[-1]
    f0, d0 = float(sc["scan_hz"][0]), float(sc["spur_level_dbc"])
    res = {"spur_found_hz": f0, "spur_planted_hz": sc["spur_hz"], "spur_dbc": d0,
           "mask_margin_db": sc["mask_margin_db"], "evm_rms": float(sc["vsa"]["evm_rms"]),
           "mcs": sc["mcs"]}
    res["ok"] = bool(sc["scan_valid"][0]) and abs(f0 - sc["spur_hz"]) <= bin_hz and abs(
        d0 - SPUR_DBC) <= SPUR_DBC_TOL and sc["mask_ok"]
    return res


def access_bars(out: dict, truth: dict) -> dict:
    """The gate's bars: channels 2-5 busy in every block, 8 and 11 busy only
    in blocks where they key (and in every block where they key at least
    KEYED_BUSY_S), every other channel idle in every block; the duty
    cycles within DUTY_TOL of the planted ones on 8 and 11 and 1.0 on 2-5;
    the features flag channel 13 and no other idle channel; no lease on
    2-5, 8, 11 or 13; channel 6 classified "tone", its excision
    ≥ EXCISE_DROP_DB at the tone's bin and ≤ EXCISE_MEDIAN_DB at the
    median bin."""
    busy = out["busy"].cpu().numpy()
    rows, block = truth["rows"], truth["block"]
    res = {"busy_blocks": busy.sum(axis=0).tolist()}
    ok = bool(busy[:, list(OFDM_CHANNELS)].all())
    quiet = [c for c in range(N_CHANNELS) if c not in OFDM_CHANNELS + FM_CHANNELS]
    ok &= not busy[:, quiet].any()
    duty = torch.mean(out["duty"], dim=0).cpu().numpy()
    res["duty"] = {c: float(duty[c]) for c in OFDM_CHANNELS + FM_CHANNELS}
    res["duty_planted"] = {c: truth["duty"][c] for c in FM_CHANNELS}
    res["keyed_blocks"] = {}
    for c in FM_CHANNELS:
        keyed = _keyed_samples(truth["bursts"][c], rows, block)
        res["keyed_blocks"][c] = int(np.sum(keyed > 0))
        ok &= not np.any(busy[:, c] & (keyed == 0))
        ok &= bool(np.all(busy[:, c][keyed >= KEYED_BUSY_S * DSA_RATE_HZ]))
        ok &= abs(float(duty[c]) - truth["duty"][c]) <= DUTY_TOL
    ok &= all(abs(float(duty[c]) - 1.0) <= DUTY_TOL for c in OFDM_CHANNELS)
    res["flagged"] = out["flagged"]
    ok &= out["flagged"] == [BPSK_CHANNEL]
    incumbents = set(OFDM_CHANNELS + FM_CHANNELS + (BPSK_CHANNEL,))
    res["grants"] = out["grants"]
    ok &= all(g is not None and g not in incumbents for g in out["grants"].values())
    labels = dict(zip(out["candidates"], out["labels"]))
    res["labels"] = labels
    ok &= labels.get(TONE_CHANNEL) == "tone"
    exc = out["excision"].get(TONE_CHANNEL)
    if exc is None:
        ok = False
    else:
        res["excise_drop_db"] = float(exc["drop_db"])
        res["excise_median_shift_db"] = float(exc["median_shift_db"])
        ok &= res["excise_drop_db"] >= EXCISE_DROP_DB and abs(
            res["excise_median_shift_db"]) <= EXCISE_MEDIAN_DB
    res["feature"] = dict(zip(out["candidates"], out["feature"].cpu().tolist()))
    res["off_feature"] = dict(zip(out["candidates"], out["off_feature"].cpu().tolist()))
    res["entropy"] = dict(zip(out["candidates"], out["entropy"].cpu().tolist()))
    res["ok"] = bool(ok)
    return res


def spectrum_access_gate(device=DEFAULT_DEVICE, rows: int = DSA_ROWS,
                         block: int = DSA_BLOCK) -> dict:
    """The scene (`dsa_scene`) through the DSA cycle on `device`, then
    the self-check at the first user's MCS. Returns ``ok`` (the bars; only
    at the full width do the bars hold), the bars, the stage times, the
    launches of each hand-written kernel, the seconds end to end (upload
    to the last stage; the numpy scene not counted), the chain's outputs,
    the self-check, and the capture (on `device`)."""
    device = resolve_device(device)
    host, truth = dsa_scene(rows, block)
    before = launch_counts()
    _synchronize(device)
    t0 = time.perf_counter()
    capture = torch.from_numpy(host).to(device)
    out = spectrum_access_chain(capture)
    _synchronize(device)
    seconds = time.perf_counter() - t0
    first = out["mcs"][USERS[0]]
    sc = self_check(cg.link_adapt(LINK_MARGIN_DB) if first is None else first, device)
    launches = _launched(before)
    bars = access_bars(out, truth)
    bars["self_check"] = self_check_bars(sc)
    bars["ok"] = bars["ok"] and bars["self_check"]["ok"]
    return {"ok": bars["ok"], "bars": bars, "stage_ms": out["stage_ms"], "launches": launches,
            "seconds": seconds, "outputs": out, "self_check": sc, "truth": truth,
            "capture": capture, "samples": int(host.size), "device": str(device)}


def _ties(values: torch.Tensor, threshold) -> torch.Tensor:
    threshold = torch.as_tensor(threshold, dtype=values.dtype, device=values.device)
    return torch.abs(values - threshold) <= TIE_REL * torch.abs(threshold)


def access_agreement(card: dict, cpu: dict, card_sc: dict | None = None,
                     cpu_sc: dict | None = None) -> dict:
    """A card run of the chain against a CPU run of the same blocks: busy
    masks equal but where a CPU channel lies within TIE_REL of its
    threshold (counted), the candidates, feature flags, class labels,
    leases, grants and MCS equal; occupancy dB, duty, features, entropies,
    the enhanced waterfall (as power, its square root undone) and the
    anomaly scores within FLOAT_TOL, the channels within CHANNEL_TOL; the
    self-checks' EVM within EVM_REL_TOL of the CPU's, their spur scans and
    mask verdicts equal and their spur levels within FLOAT_TOL."""
    ch_db = cpu["ch_db"]
    floor = sp2.median(ch_db, dim=-1, keepdim=True)
    tie = _ties(ch_db, floor + OCCUPANCY_DB)
    diff = card["busy"].cpu() != cpu["busy"]
    res = {"busy_ties": int(torch.sum(tie)), "busy_differs_off_ties": int(torch.sum(diff & ~tie))}
    for key in ("candidates", "flagged", "labels", "leases", "grants", "mcs"):
        res[f"{key}_equal"] = card[key] == cpu[key]
    res["ch_db_rel"] = compare(card["ch_db"], ch_db)
    res["duty_rel"] = compare(card["duty"], cpu["duty"])
    res["feature_rel"] = compare(card["caf"], cpu["caf"]) if res["candidates_equal"] else math.inf
    res["entropy_rel"] = compare(card["entropy"], cpu["entropy"]) if res[
        "candidates_equal"] else math.inf
    res["enhanced_rel"] = compare(card["enhanced"] ** 2, cpu["enhanced"] ** 2)
    res["anomaly_rel"] = compare(card["anomaly"], cpu["anomaly"])
    res["channels_rel"] = compare(card["channels"], cpu["channels"]) if res[
        "candidates_equal"] else math.inf
    ok = res["busy_differs_off_ties"] == 0 and all(
        res[f"{k}_equal"] for k in ("candidates", "flagged", "labels", "leases", "grants", "mcs"))
    ok = ok and max(res["ch_db_rel"], res["duty_rel"], res["feature_rel"], res["entropy_rel"],
                    res["enhanced_rel"], res["anomaly_rel"]) <= FLOAT_TOL and res[
        "channels_rel"] <= CHANNEL_TOL
    if card_sc is not None and cpu_sc is not None:
        e_card, e_cpu = float(card_sc["vsa"]["evm_rms"]), float(cpu_sc["vsa"]["evm_rms"])
        res["evm_card"], res["evm_cpu"] = e_card, e_cpu
        res["spur_equal"] = (card_sc["scan_hz"].cpu().tolist() == cpu_sc["scan_hz"].tolist()
                             and card_sc["scan_valid"].cpu().tolist()
                             == cpu_sc["scan_valid"].tolist())
        res["spur_dbc_rel"] = compare(card_sc["scan_dbc"], cpu_sc["scan_dbc"])
        res["spur_level_rel"] = compare(card_sc["spur_level_dbc"], cpu_sc["spur_level_dbc"])
        res["mask_equal"] = card_sc["mask_ok"] == cpu_sc["mask_ok"]
        ok = ok and abs(e_card - e_cpu) <= EVM_REL_TOL * e_cpu and res["spur_equal"] and res[
            "mask_equal"] and max(res["spur_dbc_rel"], res["spur_level_rel"]) <= FLOAT_TOL
    res["ok"] = bool(ok)
    return res


def waterfall_agreement(out: dict) -> dict:
    """The chain's waterfall stage at its size against the CPU: the card's
    `waterfall_enhance` and `spectrogram_anomaly_score` of the card's
    waterfall held against the same functions of that waterfall copied to
    the CPU. At the full width the image holds 2^25 values, past
    ``torch.quantile``'s limit of 2^24, so this is the sort-and-interpolate
    percentile at the size that needs it. Within FLOAT_TOL (the enhanced
    image as power)."""
    wf = out["waterfall"].cpu()
    res = {"values": wf.numel(),
           "enhanced_rel": compare(out["enhanced"] ** 2, sp2.waterfall_enhance(wf) ** 2),
           "anomaly_rel": compare(out["anomaly"], sp2.spectrogram_anomaly_score(wf, ANOMALY_TRAIN))}
    res["ok"] = max(res["enhanced_rel"], res["anomaly_rel"]) <= FLOAT_TOL
    return res


# ------------------------------------------------------------ blocks gate

BLOCKS_TOL = 1e-5          # max|card − CPU| / max|CPU|: FFTs, sums and products in another order
BLOCKS_LOOP_TOL = 1e-4     # step loops of float32 products (EM, PAST, SVT, unmixing, power control)
BLOCKS_SOLVE_TOL = 1e-3    # float32 solves of ill-conditioned normal equations, SVDs


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _cplx(rng, *shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(
        np.complex64)


def _hosvd_rebuilt(t):
    """HOSVD by what is unique: the tensor rebuilt from its core and
    factors, and the core's singular values."""
    core, factors = sp2.hosvd(t)
    out = core
    for mode, u in enumerate(factors):
        out = torch.movedim(torch.tensordot(u, torch.movedim(out, mode, 0), dims=1), 0, mode)
    return out, torch.linalg.svdvals(core.reshape(core.shape[0], -1))


def _past(x):
    """PAST by its projector Q·Qᴴ and its norms."""
    q, norms = sp2.past_subspace_track(x, 1)
    return q @ q.mH, norms


def _engine(x):
    eng = cg.CognitiveEngine(16)
    return [torch.as_tensor([eng.step(x, s)["channel"] for s in (1.0, 12.0)]),
            torch.as_tensor(eng.learner.p_idle)]


def _broker(occ):
    b = cg.SpectrumBroker(8)
    grants = [b.request(u, occ) for u in "abc"]
    b.release("a")
    return torch.as_tensor(grants + [b.request("d", occ)])


def _learner(busy):
    lrn = cg.SpectrumLearner(busy.shape[-1])
    for row in busy:
        lrn.observe(row)
    return torch.as_tensor(lrn.p_idle), torch.as_tensor(lrn.pick())


def _analyzer(x):
    res = analysis.SpectrumAnalyzer(100e3, 1024).compute(x, n_peaks=2)
    return (torch.from_numpy(10.0 ** (res.psd_db / 10.0)), torch.as_tensor(
        [p.bin for p in res.peaks]), torch.as_tensor([res.bandwidth_3db_hz,
                                                      res.occupied_bandwidth_hz]))


def _waterfall(x):
    return 10.0 ** (analysis.Waterfall(50e3, 128).power_db(x) / 10.0)


def _values(d: dict, *keys):
    return [d[k] for k in keys]


def _blocks_cases():
    """(name, function, numpy inputs as (args, kwargs), tolerance): every
    BLOCKS entry of spectral2, cognitive, instruments and sensing (named
    module.entry) and the two analysis classes, on the inputs of their JAX
    tests (tests/test_spectral2.py, test_cognitive_propagation.py,
    test_bio_nav_instruments.py, test_sensing.py, test_mesh_registry.py and
    the known-answer files)."""
    tol, ltol, stol = BLOCKS_TOL, BLOCKS_LOOP_TOL, BLOCKS_SOLVE_TOL
    r = _rng(48)
    bpsk = (np.repeat(2.0 * r.integers(0, 2, 512) - 1.0, 8) + 0.1 * _cplx(r, 4096)).astype(
        np.complex64)
    noise = _cplx(r, 8192)
    t2k = np.arange(2048)
    qpc = (np.cos(0.3 * t2k) + np.cos(0.5 * t2k) + np.cos(0.8 * t2k)).astype(np.float32)
    emd_x = (np.sin(2 * np.pi * 0.2 * t2k) + 0.5 * np.sin(2 * np.pi * 0.01 * t2k)).astype(
        np.float32)
    damped = (np.exp((-0.02 + 0.3j) * np.arange(64)) + 0.5 * np.exp(
        (-0.01 - 0.7j) * np.arange(64))).astype(np.complex64)
    tone = (np.exp(2j * np.pi * 0.11 * np.arange(4096)) + 0.2 * _cplx(r, 4096)).astype(
        np.complex64)
    gmm = np.concatenate([r.normal(-2, 0.5, 500), r.normal(3, 1.0, 700)]).astype(np.float32)
    low_rank = np.outer(r.standard_normal(12), r.standard_normal(10)).astype(np.float32)
    mask = (r.random((12, 10)) < 0.6).astype(np.float32)
    cube3 = r.standard_normal((4, 5, 3)).astype(np.float32)
    v6 = np.exp(1j * np.arange(6) * 0.7)
    stream = (np.outer(r.standard_normal(200), v6) + 0.05 * _cplx(r, 200, 6)).astype(np.complex64)
    img = (r.standard_normal((40, 64)) + np.linspace(0, 3, 64)).astype(np.float32)
    band = _cplx(r, 1 << 15)
    for ch in (3, 12):
        band += np.exp(2j * np.pi * ((ch + 0.5) / 16 - 0.5) * np.arange(1 << 15)).astype(
            np.complex64)
    spread = (2.0 * r.integers(0, 2, 16384) - 1.0).astype(np.complex64)
    jammed = spread + (10.0 * np.exp(2j * np.pi * 0.13 * np.arange(16384))).astype(np.complex64)
    gains = np.float32([[1.0, 0.1], [0.1, 1.0]])
    busy_tl = np.arange(100) < 50
    mask_pts = [(0.0, 0.0), (1e6, -20.0), (5e6, -60.0)]
    fs = 1e6
    tt = np.arange(8192) / fs
    two_tone = (np.exp(2j * np.pi * 100e3 * tt) + 1e-3 * np.exp(2j * np.pi * -230e3 * tt)
                + 1e-3 * _cplx(r, 8192)).astype(np.complex64)
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))).astype(np.complex64)
    syms = qpsk[r.integers(0, 4, 2000)] + 0.05 * _cplx(r, 2000)
    chirp = np.exp(1j * np.pi * np.arange(4096) ** 2 / 4096).astype(np.complex64)
    scope = np.sin(2 * np.pi * 0.013 * np.arange(3000)).astype(np.float32)
    edges = (np.arange(200) * 1e-6 + 2e-9 * r.standard_normal(200)).astype(np.float32)
    iq = _cplx(r, 4096)
    iq = (iq.real + 1j * (1.2 * iq.imag + 0.1 * iq.real)).astype(np.complex64)
    emi = (np.sin(2 * np.pi * 150e3 * np.arange(20000) / 2e6) + 0.01 * r.standard_normal(20000))
    locked = (np.exp(2j * np.pi * 1234.0 * np.arange(4096) / 48e3) + 0.05 * _cplx(r, 4096))
    carrier = np.sin(2 * np.pi * 0.01 * np.arange(1024)).astype(np.float32)
    pd = np.exp(1j * 2.0 * np.sin(2 * np.pi * 500 * np.arange(9600) / 48e3 + 0.9)).astype(
        np.complex64)
    ae = 0.01 * r.standard_normal(4096)
    ae[1000:1020] += 2.0
    ae[3000:3010] += 1.5
    mics = np.stack([np.roll(r.standard_normal(1024), d) for d in (0, 7, -5, 12)]).astype(
        np.complex64)
    proj = np.maximum(0, 1 - np.linspace(-1.5, 1.5, 41) ** 2)[None].repeat(12, 0).astype(
        np.float32)
    beacon = (0.05 * r.standard_normal(20000) + 0j).astype(np.complex64)
    for k in range(0, 20000, 4000):
        beacon[k:k + 800] += 1.0
    audio = (np.sin(2 * np.pi * 150 * np.arange(8192) / 8e3) + 0.1 * r.standard_normal(8192))
    vib = np.sin(2 * np.pi * 3 * np.arange(20000) / 1e3) + 0.1 * r.standard_normal(20000)
    wheel = 0.05 * r.standard_normal(8000)
    wheel[::400] += 3.0
    bearing = (np.sin(2 * np.pi * 2000 * np.arange(16384) / 20e3) * (
        1 + 0.5 * (np.sin(2 * np.pi * 87 * np.arange(16384) / 20e3) > 0.9))
        + 0.05 * r.standard_normal(16384))
    quake = 0.05 * r.standard_normal(6000)
    quake[3000:] += np.exp(-np.arange(3000) / 1000.0) * np.sin(
        2 * np.pi * 2.0 * np.arange(3000) / 100.0) * 3.0
    efield = 0.1 * r.standard_normal(8000)
    efield[2000:2030] += np.linspace(3, 0, 30)
    efield[5000:5020] -= np.linspace(4, 0, 20)
    det_b = 0.1 * r.standard_normal(3000)
    det_b[[102, 1500, 1999]] += 5.0
    mag = (np.linspace(0, 20, 2000) + r.standard_normal(2000) * 0.3).astype(np.float32)
    mag[1000:1010] += 12.0
    spec = np.exp(-0.5 * ((np.arange(200) - 120.3) / 4.0) ** 2).astype(np.float32)
    wl = np.linspace(1540, 1560, 200).astype(np.float32)
    pa_pos = np.stack([np.cos(np.arange(8)), np.sin(np.arange(8))], -1).astype(np.float32) * 0.02
    pa_px = np.stack(np.meshgrid(np.linspace(-0.01, 0.01, 6), np.linspace(-0.01, 0.01, 6)),
                     -1).reshape(-1, 2).astype(np.float32)
    fid_t = np.arange(2048) / 1000.0
    fid = (np.exp((2j * np.pi * 120 - 5) * fid_t) + 0.5 * np.exp((-2j * np.pi * 80 - 5) * fid_t))
    heights = np.concatenate([r.normal(662, 15, 3000), r.normal(1332, 20, 2000),
                              r.uniform(0, 3000, 4000)]).astype(np.float32)
    volts = np.linspace(-20, 10, 300).astype(np.float32)
    curr = (-0.1 + 2.0 * np.exp(np.minimum(volts, 5) / 3.0)).astype(np.float32)
    endm = np.abs(r.standard_normal((3, 20))).astype(np.float32)
    hs_cube = (r.dirichlet(np.ones(3), 50) @ endm + 0.01 * r.standard_normal((50, 20)))
    hours = np.arange(0, 24 * 30, 0.5).astype(np.float32)
    tide = (1.2 * np.cos(2 * np.pi * hours / 12.42 - 0.3) + 0.4 * np.cos(
        2 * np.pi * hours / 12.0 + 1.0) + 0.1 * r.standard_normal(hours.size))
    sweep_phase = 2 * np.pi * np.cumsum(np.linspace(-15e3, 15e3, 20000)) / 50e3
    return [
        # spectral2 (tests/test_spectral2.py, test_known_answers_r4k.py)
        ("spectral2.cyclic_autocorrelation", lambda x: sp2.cyclic_autocorrelation(
            x, [0.0, 0.125, 0.0462], 4), ((bpsk,), {}), ltol),
        ("spectral2.spectral_correlation_analyzer", lambda x: sp2.spectral_correlation(x, 128, 16),
         ((noise,), {}), tol),
        ("spectral2.bispectrum_analyzer", lambda x: sp2.bispectrum(x, 64), ((qpc,), {}), tol),
        ("spectral2.empirical_mode", sp2.emd, ((emd_x,), {}), tol),
        ("spectral2.prony_method", lambda x: sp2.prony(x, 2), ((damped,), {}), tol),
        ("spectral2.modal_analysis_prony", lambda x: sp2.modal_frequencies(x, 1000.0, 4),
         ((damped,), {}), tol),
        ("spectral2.time_frequency_reassignment", lambda x: sp2.reassigned_spectrogram(
            x, 1.0, 64, 16), ((tone[:1024],), {}), tol),
        ("spectral2.entropy_calculator", sp2.spectral_entropy, ((tone,), {}), tol),
        ("spectral2.power_law_spectrum_estimator", lambda x: sp2.power_law_fit(x, 1.0, 256),
         ((np.cumsum(r.standard_normal(4096)).astype(np.float32),), {}), tol),
        ("spectral2.phase_coherence_analyzer", sp2.phase_locking_value, ((tone, bpsk), {}), tol),
        ("spectral2.expectation_maximization", sp2.em_gmm_1d, ((gmm,), {}), ltol),
        ("spectral2.matrix_completion_nuclear", lambda y, m: (
            sp2.matrix_complete_svt(y, m, rank=1, n_iter=30), sp2.matrix_complete_svt(
                y, m, n_iter=30)), ((low_rank * mask, mask), {}), stol),
        ("spectral2.tensor_hosvd", _hosvd_rebuilt, ((cube3,), {}), stol),
        ("spectral2.subspace_tracker", _past, ((stream,), {}), stol),
        ("spectral2.spectrogram_anomaly_detector", sp2.spectrogram_anomaly_score, ((img,), {}),
         tol),
        ("spectral2.waterfall_image_enhancer", sp2.waterfall_enhance, ((img,), {}), tol),
        ("spectral2.time_raster", lambda b: sp2.time_raster(b, 7),
         ((r.integers(0, 2, 100).astype(np.int32),), {}), tol),
        # cognitive (tests/test_cognitive_propagation.py, known-answer files)
        ("cognitive.dynamic_spectrum_manager", lambda x: cg.channel_occupancy(x, 16),
         ((band,), {}), tol),
        ("cognitive.cognitive_radio_spectrum_broker", _broker,
         ((np.float32([10.0, -20.0, 5.0, -10.0, 3.0, 7.0, -1.0, 0.5]),), {}), tol),
        ("cognitive.cognitive_radio_spectrum_learner", _learner,
         ((np.tile(np.int32([1, 0, 1, 0, 0]), (50, 1)),), {}), tol),
        ("cognitive.cognitive_engine", _engine, ((band,), {}), tol),
        ("cognitive.spectrum_coexistence_analyzer", cg.coexistence_report, ((band,), {}), tol),
        ("cognitive.interference_classifier", lambda x: torch.as_tensor(
            [["tone", "chirp", "pulsed", "wideband"].index(cg.interference_classify(x, 1e6))]),
         ((band[:8192],), {}), tol),
        ("cognitive.interference_excision", cg.interference_excise, ((jammed,), {}), tol),
        ("cognitive.link_adaptation_engine", lambda x: torch.as_tensor(
            [cg.link_adapt(float(s), 2.0, 3) for s in x]), ((np.arange(-5.0, 26.0),), {}), tol),
        ("cognitive.carrier_aggregation_scheduler", lambda s: torch.as_tensor(
            [b for u in cg.carrier_aggregation_schedule(s, {"u1": 1500, "u2": 500}).values()
             for b in u]), ((np.float32([20.0, 5.0, 12.0]),), {}), tol),
        ("cognitive.power_control", lambda s: cg.power_control_step(s, 10.0),
         ((np.float32([3.0, 12.0, 9.5]),), {}), tol),
        ("cognitive.adaptive_power_controller", lambda g, nz: cg.power_control_converge(
            g, nz, 10.0), ((gains, np.float32([0.01, 0.01])), {}), ltol),
        ("cognitive.timing_advance_estimator", lambda x: torch.as_tensor(
            cg.timing_advance(1030, 1000, 1e6)), ((np.zeros(1),), {}), tol),
        ("cognitive.lorawan_mac_scheduler", lambda x: torch.as_tensor(
            cg.lorawan_schedule({"dev1": 1.0}, 0.01, 1000.0)["dev1"]), ((np.zeros(1),), {}), tol),
        ("cognitive.csma_ca_mac", lambda b: cg.csma_backoff_trace(b, seed=1), ((busy_tl,), {}),
         tol),
        ("cognitive.waveform_diversity_scheduler", lambda x: torch.as_tensor(
            [len(cg.waveform_diversity_pick(e)) for e in (
                {"jamming": True}, {"multipath_rms_us": 5.0}, {"snr_db": -5.0}, {})]),
         ((np.zeros(1),), {}), tol),
        ("cognitive.rf_signal_router", lambda a, b: list(cg.rf_route(
            {"a": a, "b": b}, {"out1": ["a", "b"], "out2": ["b"]}).values()),
         ((np.ones(4, np.float32), 2 * np.ones(4, np.float32)), {}), tol),
        ("cognitive.spectral_mask", lambda f: cg.spectral_mask(f, mask_pts),
         ((np.float32([0.0, 2e6, -3e6, 7e6]),), {}), tol),
        ("cognitive.spectral_mask_painter", lambda p, f: cg.mask_compliance(p, f, mask_pts),
         ((np.float32([-30.0, -70.0]), np.float32([1e6, 5e6])), {}), tol),
        ("cognitive.lpi_metrics", lambda x: _values(cg.lpi_metrics(x), "psd_peak_avg_db",
                                                    "spectral_entropy", "envelope_kurtosis"),
         ((band[:16384],), {}), tol),
        # instruments (tests/test_bio_nav_instruments.py, known-answer files)
        ("instruments.network_analyzer", inst.network_analyzer_s21,
         ((chirp, np.convolve(chirp, [1.0, 0.5, 0.2])[:4096].astype(np.complex64)), {}), tol),
        ("instruments.oscilloscope_trigger", lambda x: inst.oscilloscope_trigger(x, 0.5, holdoff=40),
         ((scope,), {}), tol),
        ("instruments.jitter_analyzer", lambda e: _values(inst.jitter_analyze(e, 1e-6), "tie",
                                                          "tie_rms_s", "period_jitter_rms_s"),
         ((edges,), {}), tol),
        ("instruments.power_meter", inst.power_meter_dbm, ((syms,), {}), tol),
        ("instruments.vector_signal_analyzer", lambda x: _values(
            inst.vector_signal_analyze(x, qpsk), "evm_rms", "decision_margin", "mag_error",
            "phase_error_rad", "papr_db", "snr_est_db"), ((syms,), {}), tol),
        ("instruments.transmission_line_simulator", lambda x: torch.as_tensor(
            inst.transmission_line_input_impedance(25 - 40j, 50.0, np.pi / 3)),
         ((np.zeros(1),), {}), tol),
        ("instruments.rf_impedance_tuner", lambda x: torch.as_tensor(inst.stub_match(25 - 40j)),
         ((np.zeros(1),), {}), tol),
        ("instruments.rf_circuit_em_simulator", lambda x: torch.as_tensor(
            [inst.microstrip_impedance(u) for u in (0.5, 2.0)]), ((np.zeros(1),), {}), tol),
        ("instruments.antenna_design_optimizer", lambda x: torch.as_tensor(
            inst.dipole_optimize(433e6)), ((np.zeros(1),), {}), tol),
        ("instruments.rf_impairment_calibrator", lambda x: (
            inst.iq_impairment_calibrate(x)[0], inst.iq_impairment_calibrate(x)[1]["gain"]),
         ((iq,), {}), tol),
        ("instruments.passive_intermod_analyzer", lambda x: inst.pim_level(x, 100e3, 130e3, fs),
         ((two_tone,), {}), tol),
        ("instruments.emi_conducted_analyzer", lambda x: inst.emi_conducted_scan(x, 2e6),
         ((emi,), {}), tol),
        ("instruments.emc_radiated_immunity", lambda f: inst.immunity_test_levels(f, 10.0),
         ((np.float32([80e6, 1e9]),), {}), tol),
        ("instruments.injection_locking_detector", lambda x: inst.injection_locking_detect(
            x, 48e3, 1000.0), ((locked,), {}), tol),
        ("instruments.spurious_emission_scanner", lambda x: inst.spur_scan(
            x, fs, 100e3, threshold_dbc=-80.0), ((two_tone,), {}), tol),
        ("instruments.spurs_mitigation", lambda x: inst.spur_cancel(x, [-230e3], fs),
         ((two_tone,), {}), tol),
        ("instruments.direction_finding_watson_watt", lambda c: inst.watson_watt_bearing(
            0.82 * c, 0.57 * c, -c), ((carrier,), {}), tol),
        ("instruments.radio_direction_finder", lambda x: inst.df_bearing_pseudodoppler(
            x, 48e3, 500.0), ((pd,), {}), tol),
        ("instruments.rdf_network_triangulator", inst.triangulate_bearings,
         ((np.float32([[0, 0], [1000, 0], [0, 1000]]), np.float32([45.0, 315.0, 135.0])), {}),
         stol),
        ("instruments.gps_spoofing_detector", lambda c, d: torch.as_tensor(
            inst.gps_spoof_detect(c, d, 2e-6)[0]), ((np.full(8, 48.0), np.full(8, 10.0)), {}),
         tol),
        ("instruments.modulation_fingerprinter", inst.modulation_fingerprint, ((syms,), {}), tol),
        ("instruments.rf_fingerprinting_engine", inst.rf_device_fingerprint, ((iq,), {}), tol),
        ("instruments.rf_environment_mapper", lambda p, xy: inst.rf_environment_map(p, xy, 16, 50.0),
         ((np.float32([-40.0, -70.0, -55.0]), np.float32([[10, 20], [-30, 5], [0, -40]])), {}),
         tol),
        ("instruments.protocol_anomaly_detector", inst.protocol_anomaly_score,
         ((r.integers(60, 80, 50).astype(np.float32), r.exponential(1.0, 50).astype(
             np.float32)), {}), tol),
        ("instruments.radio_astronomy_receiver", inst.radiometer_total_power, ((iq,), {}), tol),
        ("instruments.radio_telescope_correlator", lambda a, b: inst.telescope_cross_correlate(
            a, b, 16), ((iq[:1000], np.roll(iq[:1000], 5)), {}), tol),
        # sensing (tests/test_sensing.py, known-answer files)
        ("sensing.acoustic_emission_sensor", sn.acoustic_emission_count, ((ae,), {}), tol),
        ("sensing.acoustic_gunshot_localizer", lambda m, p: sn.gunshot_localize(list(m), p, 48e3),
         ((mics, np.float32([[0, 0], [30, 0], [0, 30], [30, 30]])), {}), ltol),
        ("sensing.acoustic_impedance_tomographer", lambda m: sn.impedance_tomography_backproject(
            m, np.linspace(0, 165, 12), 24), ((proj,), {}), tol),
        ("sensing.acoustic_leak_locator", lambda a, b: sn.leak_locate(a, b, 100.0, 10e3),
         ((mics[0], mics[1]), {}), tol),
        ("sensing.avalanche_transceiver_correlator", lambda x: sn.avalanche_beacon_search(
            x, 10e3, frame_s=0.01), ((beacon,), {}), tol),
        ("sensing.drone_acoustic_detector", lambda a: sn.drone_acoustic_detect(a, 8e3),
         ((audio,), {}), tol),
        ("sensing.vibration_order_tracker", lambda v, p: sn.envelope_order_spectrum(
            v, 1e3, p, 6, 64), ((vib, np.full(20000, 600.0)), {}), tol),
        ("sensing.railroad_wheel_flat_detector", lambda v: sn.wheel_flat_detect(v, 1e3, 2.0, 5.0),
         ((wheel,), {}), tol),
        ("sensing.turbine_blade_tip_timing", lambda t: sn.turbine_tip_timing(t, 3600.0, 8),
         ((np.sort(r.uniform(0, 1, 64)).astype(np.float32),), {}), tol),
        ("sensing.engine_vibration_signature", lambda v: _values(
            sn.bearing_health_bands(v, 20e3, 87.0, 140.0), "bpfo", "bpfi"), ((bearing,), {}), tol),
        ("sensing.wind_turbine_vibration_monitor", lambda v: _values(
            sn.bearing_health_bands(v, 20e3, 60.0, 210.0), "bpfo", "bpfi"), ((bearing,), {}),
         tol),
        ("sensing.structural_health_monitor", lambda a, b: sn.structural_modal_shift(a, b, 20e3),
         ((bearing, bearing[::-1].copy()), {}), tol),
        ("sensing.dam_seepage_monitor", lambda x: sn.dam_seepage_score(x, 20e3), ((bearing,), {}),
         tol),
        ("sensing.seismic_arrival_detector", lambda x: sn.sta_lta(x, 50, 500), ((quake,), {}),
         tol),
        ("sensing.seismic_processor", lambda x: sn.seismic_pick(x, 100.0), ((quake,), {}), tol),
        ("sensing.seismograph_event_classifier", lambda x: torch.as_tensor(
            ["noise", "blast", "earthquake"].index(sn.seismic_classify(x, 100.0))),
         ((quake,), {}), tol),
        ("sensing.ionospheric_scintillation_detector", sn.scintillation_s4,
         ((r.gamma(4.0, 0.25, 1000),), {}), tol),
        ("sensing.ionospheric_scintillation_analyzer", sn.scintillation_sigma_phi,
         ((np.cumsum(0.01 * r.standard_normal(1000)),), {}), tol),
        ("sensing.geomagnetic_storm_detector", lambda b: sn.geomagnetic_storm_index(b, 1.0, 60.0),
         ((np.cumsum(r.standard_normal(3600)),), {}), tol),
        ("sensing.magnetic_anomaly_detector", lambda b: sn.magnetic_anomaly_detect(b, 64, 3.0),
         ((mag,), {}), tol),
        ("sensing.gravity_gradiometer_processor", lambda g: sn.gravity_gradient_tensor(g, 5.0),
         ((np.add.outer(np.linspace(0, 1, 12), np.linspace(0, 2, 9)),), {}), tol),
        ("sensing.lightning_stroke_analyzer", lambda e: sn.lightning_stroke_analyze(
            e, 1e5, 6.0, 8), ((efield,), {}), tol),
        ("sensing.cosmic_ray_detector", sn.cosmic_ray_coincidence, ((ae[:3000], det_b), {}), tol),
        ("sensing.fiber_bragg_interrogator", sn.fbg_wavelength_shift, ((spec, wl), {}), tol),
        ("sensing.optical_coherence_tomography", sn.oct_a_scan,
         ((np.cos(2 * np.pi * 37 * np.arange(1024) / 1024) + 1.0,), {}), tol),
        ("sensing.photoacoustic_reconstructor", sn.photoacoustic_reconstruct,
         ((r.standard_normal((8, 400)), pa_pos, pa_px), {}), tol),
        ("sensing.mr_spectroscopy_processor", lambda x: sn.mrs_quantify(
            x, 1000.0, [120.0, -80.0, 499.0]), ((fid,), {}), tol),
        ("sensing.nuclear_spectroscopy_analyzer", sn.gamma_spectrum, ((heights,), {}), tol),
        ("sensing.particle_accelerator_bpm", lambda a, b, c, d: sn.bpm_position([a, b, c, d]),
         ((np.float32([1.2, 0.9]), np.float32([0.8, 1.1]), np.float32([0.7, 1.0]),
           np.float32([1.1, 0.95])), {}), tol),
        ("sensing.plasma_diagnostics_processor", lambda v, i: _values(
            sn.langmuir_analyze(v, i), "v_float", "te_ev"), ((volts, curr), {}), tol),
        ("sensing.plasma_impedance_analyzer", sn.plasma_impedance,
         ((np.sin(2 * np.pi * 5 * np.arange(512) / 512),
           0.5 * np.sin(2 * np.pi * 5 * np.arange(512) / 512 - 0.4)), {}), tol),
        ("sensing.hyperspectral_unmixing", sn.hyperspectral_unmix, ((hs_cube, endm), {}), ltol),
        ("sensing.precision_ag_soil_sensor", sn.soil_moisture_permittivity,
         ((np.linspace(0.05, 0.9, 30),), {}), tol),
        ("sensing.pulse_oximeter_processor", lambda a: sn.spo2_ratio(a, 2.0, a * 1.3, 2.5),
         ((np.linspace(0.01, 0.05, 9),), {}), tol),
        ("sensing.tidal_harmonic_analyzer", sn.tidal_harmonic_fit, ((tide, hours), {}), stol),
        # analysis (tests/test_mesh_registry.py): the PSD as power, the peaks, the bandwidths
        ("analysis.SpectrumAnalyzer", _analyzer,
         (((np.exp(2j * np.pi * 10e3 * np.arange(32768) / 100e3) + 0.3 * np.exp(
             -2j * np.pi * 20e3 * np.arange(32768) / 100e3)).astype(np.complex64),), {}), tol),
        ("analysis.Waterfall", _waterfall, ((np.exp(1j * sweep_phase).astype(np.complex64),), {}),
         tol),
    ]


def blocks_names() -> list[str]:
    """Every `BLOCKS` entry of the slice as module.entry, and the two
    analysis classes."""
    return ([f"{m.__name__.rsplit('.', 1)[-1]}.{k}" for m in (sp2, cg, inst, sn) for k in m.BLOCKS]
            + ["analysis.SpectrumAnalyzer", "analysis.Waterfall"])


def sensing_blocks_gate(device=DEFAULT_DEVICE) -> dict:
    """Every case of `_blocks_cases` on `device` and on the CPU (the worst
    difference a case, inf for differing decisions; each held to its
    tolerance). Returns ``ok``, ``worst`` by case, ``failed``, the worst
    case by name, and the launches of each hand-written kernel."""
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
    missing = sorted(set(blocks_names()) - set(worst))
    top = max(worst, key=lambda k: worst[k])
    return {"ok": not failed and not missing, "worst": worst, "failed": failed,
            "missing": missing, "worst_case": (top, worst[top]), "launches": _launched(before),
            "device": str(device)}

