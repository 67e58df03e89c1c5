"""The modem family's two gates: a broadcast FM stereo + RDS receiver at a
station's full width, and the family's functions card against CPU.

`fm_broadcast_gate(device, seconds, sample_rate, seed)` builds one stereo
station with RDS in numpy (`fm_station`), FM-modulates it at 75 kHz
deviation and runs the reference's own chain on it (`fm_broadcast_chain`):
``quadrature_demod`` → ``fm_stereo_decode`` and ``rds_subcarrier_demod`` on
the multiplex, and ``fm_receiver`` at 48 kHz on the IQ, with every FIR on
the FIR kernel (9 launches) and the mono de-emphasis on the recursion
kernel (1 launch), whatever the length. Its bars are the reference tests'
(``tests/test_mapping.py:129-171``), tightened to what the reference
reaches at a minute of a station.

`modem_family_gate(device)` runs each function of the family (the rest of
``ops.modem``, ``mapping``, ``events``, ``scramblers``, the RAKE receiver,
``exotic_modems`` and the emphasis filters) on its JAX test's inputs on
`device` and on the CPU: hard decisions equal, floats within the stated
tolerance. It also runs two real-size shapes: the FEC table's
convolutional codec on a 1,500-byte packet, and an LTE 20 MHz uplink
subframe through SC-FDMA.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from r4w_tpu_torch.channel import threefry
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, IQ_DTYPE, resolve_device
from r4w_tpu_torch.kernels import dechirp, fir, nco, recurrence, viterbi
from r4w_tpu_torch.ops import events, exotic_modems as xm, filters2, mapping, modem
from r4w_tpu_torch.ops import scramblers, spreading
from r4w_tpu_torch.waveforms.linear_mod import psk_constellation, qam_constellation

FM_RATE_HZ = 240e3              # a common wideband FM capture rate
FM_SECONDS = 60.0               # one minute of one station
FM_DEVIATION_HZ = 75e3          # broadcast FM peak deviation
FM_AUDIO_RATE_HZ = 48e3
FM_LEFT_HZ, FM_RIGHT_HZ = 800.0, 2000.0  # tests/test_mapping.py:129-147
RDS_BIT_RATE = 1187.5
# the multiplex's weights: (L+R)/2, the 19 kHz pilot (10% of the peak
# deviation, ITU-R BS.450), (L-R)/2 on the 38 kHz subcarrier, RDS at 57 kHz
MPX_SUM, MPX_PILOT, MPX_DIFF, MPX_RDS = 0.45, 0.1, 0.45, 0.05
FM_SEPARATION_DB = 40.0         # each channel's tone over the other's
RDS_MATCH = 0.999               # or <= 1 - RDS_MATCH: the carrier's sign ambiguity
FM_TONE_TOL_HZ = 1.0            # or one bin, when the capture is shorter than a second
FM_SKIP_SAMPLES = 2000          # the filters' transients at 240 kS/s (tests/test_mapping.py:139)
AUDIO_SKIP_SAMPLES = 500        # at 48 kHz (tests/test_mapping.py:114)
AUDIO_BAND_HZ = 15e3
FM_FIR_LAUNCHES, FM_RECURSION_LAUNCHES = 9, 1


def launch_counts() -> dict:
    """The hand-written kernels' launch counters, by kernel name."""
    return {"dechirp_power": dechirp.dechirp_power.launches,
            "fir_decimate": fir.fir_decimate.launches,
            "first_order_iir": recurrence.first_order_recurrence.launches,
            "nco_mix": nco.nco_mix.launches,
            "viterbi_forward": viterbi.viterbi_forward.launches,
            "viterbi_traceback": viterbi.viterbi_traceback.launches}


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------- FM broadcast


def fm_station(seconds: float = FM_SECONDS, sample_rate: float = FM_RATE_HZ, seed: int = 0):
    """One stereo station with RDS as complex64 IQ, built in numpy: L an
    800 Hz tone, R a 2 kHz tone, the 19 kHz pilot, L−R on the 38 kHz
    subcarrier and differentially encoded random bits at 1187.5 bit/s on
    the 57 kHz RDS subcarrier (built as ``tests/test_mapping.py:149-171``),
    FM at 75 kHz deviation with the phase summed in float64. Returns (iq,
    the RDS data bits before differential encoding)."""
    n = int(round(seconds * sample_rate))
    t = np.arange(n) / sample_rate
    left = np.sin(2 * np.pi * FM_LEFT_HZ * t)
    right = np.sin(2 * np.pi * FM_RIGHT_HZ * t)
    rng = np.random.default_rng(seed)
    n_bits = int(n / sample_rate * RDS_BIT_RATE) + 2
    diff_bits = rng.integers(0, 2, n_bits)
    enc = np.cumsum(diff_bits) % 2
    sym_idx = np.minimum((t * RDS_BIT_RATE).astype(int), n_bits - 1)
    mpx = (MPX_SUM * (left + right) / 2
           + MPX_PILOT * np.sin(2 * np.pi * 19_000.0 * t)
           + MPX_DIFF * (left - right) / 2 * np.sin(2 * np.pi * 38_000.0 * t)
           + MPX_RDS * (2.0 * enc[sym_idx] - 1.0) * np.cos(2 * np.pi * 57_000.0 * t))
    del left, right, sym_idx, t
    phase = 2 * np.pi * FM_DEVIATION_HZ * np.cumsum(mpx) / sample_rate
    return np.exp(1j * phase).astype(np.complex64), diff_bits


class _Stages:
    """Times of named stages: CUDA events on the card, the host's clock
    elsewhere (after each stage has finished)."""

    def __init__(self, device: torch.device):
        self.device, self.marks = device, []

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict:
        _synchronize(self.device)
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.device.type == "cuda" else 1e3 * (b - a)
        return out


def fm_broadcast_chain(iq: torch.Tensor, sample_rate: float) -> dict:
    """The reference's broadcast chain on IQ at `sample_rate`: the
    multiplex, L, R, the pilot flag, the RDS bits and the 48 kHz mono
    audio, with each stage's milliseconds."""
    stages = _Stages(iq.device)
    stages.mark("start")
    mpx = modem.quadrature_demod(iq, gain=sample_rate / (2.0 * np.pi * FM_DEVIATION_HZ))
    stages.mark("quadrature_demod")
    left, right, present = mapping.fm_stereo_decode(mpx, sample_rate)
    stages.mark("fm_stereo_decode")
    bits, _ = mapping.rds_subcarrier_demod(mpx, sample_rate)
    stages.mark("rds_subcarrier_demod")
    audio = mapping.fm_receiver(iq, sample_rate, FM_DEVIATION_HZ, audio_rate=FM_AUDIO_RATE_HZ)
    stages.mark("fm_receiver")
    return {"mpx": mpx, "left": left, "right": right, "present": present, "rds_bits": bits,
            "audio": audio, "stage_ms": stages.ms()}


def _spectrum(x: np.ndarray, rate: float):
    x = np.asarray(x, np.float64)
    return np.fft.rfftfreq(x.shape[0], 1 / rate), np.abs(np.fft.rfft(x * np.hanning(x.shape[0])))


def _separation_db(ch: np.ndarray, rate: float, want_hz: float, other_hz: float) -> float:
    f, s = _spectrum(ch, rate)
    return float(20 * np.log10(s[np.argmin(np.abs(f - want_hz))]
                               / s[np.argmin(np.abs(f - other_hz))]))


def _strongest_tones(audio: np.ndarray, rate: float, count: int = 2,
                     exclude_hz: float = 100.0) -> list[float]:
    """The `count` strongest spectral peaks below AUDIO_BAND_HZ, each a bin
    with the bins within `exclude_hz` of earlier picks left out."""
    f, s = _spectrum(audio, rate)
    s = np.where(f < AUDIO_BAND_HZ, s, 0.0)
    picks = []
    for _ in range(count):
        k = int(np.argmax(s))
        picks.append(float(f[k]))
        s = np.where(np.abs(f - f[k]) <= exclude_hz, 0.0, s)
    return sorted(picks)


def fm_bars(out: dict, diff_bits: np.ndarray, sample_rate: float) -> dict:
    """The gate's bars on a chain's outputs (host numpy, float64 spectra)."""
    left = out["left"].cpu().numpy()[FM_SKIP_SAMPLES:]
    right = out["right"].cpu().numpy()[FM_SKIP_SAMPLES:]
    sep_l = _separation_db(left, sample_rate, FM_LEFT_HZ, FM_RIGHT_HZ)
    sep_r = _separation_db(right, sample_rate, FM_RIGHT_HZ, FM_LEFT_HZ)
    got = out["rds_bits"].cpu().numpy()[4:-4]
    match = float(np.mean(got == diff_bits[4:4 + got.shape[0]]))
    audio = out["audio"].cpu().numpy()[AUDIO_SKIP_SAMPLES:]
    tones = _strongest_tones(audio, FM_AUDIO_RATE_HZ)
    tone_tol = max(FM_TONE_TOL_HZ, FM_AUDIO_RATE_HZ / audio.shape[0])
    tones_ok = (abs(tones[0] - FM_LEFT_HZ) <= tone_tol
                and abs(tones[1] - FM_RIGHT_HZ) <= tone_tol)
    present = bool(out["present"])
    bars = {"present": present, "separation_left_db": sep_l, "separation_right_db": sep_r,
            "rds_bits": int(got.shape[0]), "rds_match": match, "mono_tones_hz": tones,
            "tone_tol_hz": tone_tol}
    bars["ok"] = (present and sep_l >= FM_SEPARATION_DB and sep_r >= FM_SEPARATION_DB
                  and (match >= RDS_MATCH or match <= 1.0 - RDS_MATCH) and tones_ok)
    return bars


def fm_broadcast_gate(device=DEFAULT_DEVICE, seconds: float = FM_SECONDS,
                      sample_rate: float = FM_RATE_HZ, seed: int = 0) -> dict:
    """One station of `seconds` at `sample_rate`, made from `seed`, through
    the broadcast chain on `device`. Returns ``ok``, the bars, the stage
    times, the launches of each hand-written kernel, the seconds end to end
    (the station's upload included, its numpy synthesis not), the station's
    IQ and the chain's outputs (tensors on `device`)."""
    device = resolve_device(device)
    iq_host, diff_bits = fm_station(seconds, sample_rate, seed)
    before = launch_counts()
    _synchronize(device)
    t0 = time.perf_counter()
    iq = torch.from_numpy(iq_host).to(device)
    out = fm_broadcast_chain(iq, sample_rate)
    _synchronize(device)
    total = time.perf_counter() - t0
    launches = _launched(before)
    bars = fm_bars(out, diff_bits, sample_rate)
    return {"ok": bars["ok"], "bars": bars, "stage_ms": out["stage_ms"], "launches": launches,
            "seconds": total, "samples": int(iq_host.shape[0]), "iq": iq, "outputs": out,
            "device": str(device)}


# ------------------------------------------------------------ family gate

FAMILY_TOL = 1e-5         # max|card − CPU| / max|CPU|: FFTs, sums and products in another order
FAMILY_PHASE_TOL = 1e-4   # tone synthesis whose float32 phase reaches 10^5 rad (WSPR, JT65)
FAMILY_DFT_TOL = 5e-5     # 4,000-term DFT sums at phases up to 1.6e3 rad (measured 1.04e-5)
TIE_MARGIN = 1e-4         # distance margin below which a hard decision is a tie in float32
LTE_FFT, LTE_SC, LTE_CP, LTE_SYMBOLS = 2048, 1200, 144, 14  # a 20 MHz uplink subframe
LTE_TOL = 1e-5            # the symbols back, absolute
PACKET_BYTES = 1500       # the convolutional codec's packet, the Ethernet MTU


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _iq(rng, *shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _on(value, device):
    """numpy inputs as tensors on `device` (float64 → float32, int64 → int32,
    complex128 → complex64), other values unchanged."""
    if isinstance(value, np.ndarray):
        canon = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
                 np.dtype(np.complex128): np.complex64}
        return torch.from_numpy(np.array(value, dtype=canon.get(value.dtype, value.dtype))).to(
            device)
    if isinstance(value, (list, tuple)):
        return type(value)(_on(v, device) for v in value)
    return value


def _flat(value) -> list:
    """Every array in a result, in order, as numpy."""
    if isinstance(value, torch.Tensor):
        return [value.detach().cpu().numpy()]
    if isinstance(value, np.ndarray):
        return [value]
    if isinstance(value, (tuple, list)):
        return [a for v in value for a in _flat(v)]
    if isinstance(value, dict):
        return [a for k in sorted(value) for a in _flat(value[k])]
    if isinstance(value, (bool, int, float, np.generic)):
        return [np.asarray(value)]
    return []


def compare(card, cpu) -> float:
    """The worst difference of a card result from the CPU's: inf when an
    integer or boolean array differs (or a shape, or where the CPU's float
    is infinite or NaN), else the largest max|Δ|/max|CPU| over the finite
    entries of its float arrays (0 with none)."""
    got, want = _flat(card), _flat(cpu)
    if len(got) != len(want):
        return math.inf
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return math.inf
        if w.dtype.kind in "biu":
            if not np.array_equal(g, w):
                return math.inf
            continue
        finite = np.isfinite(w)
        if not np.array_equal(g[~finite], w[~finite], equal_nan=True):
            return math.inf
        g, w = g[finite], w[finite]
        if not w.size:
            continue
        scale = float(np.max(np.abs(w))) or 1.0
        err = float(np.max(np.abs(g.astype(np.complex128) - w.astype(np.complex128)))) / scale
        worst = max(worst, err)
    return worst


def decisive(idx: torch.Tensor, y: torch.Tensor, table) -> tuple:
    """(idx with -1 where y is within TIE_MARGIN of a decision boundary, y).
    The optical receiver's 4th-power loop locks the π/4-offset QPSK points
    onto the boundaries (x⁴ locked to angle 0), so most of its decisions
    are float32 ties, which an ulp of the loop's phase decides."""
    d = torch.sort(torch.abs(y[..., None] - torch.as_tensor(table, device=y.device)),
                   dim=-1).values
    return torch.where(d[..., 1] - d[..., 0] > TIE_MARGIN, idx, -1), y


def _family_cases():
    """(name, function, numpy inputs as (args, kwargs), tolerance): the
    inputs of each function's JAX test (tests/test_modem_ops.py,
    test_mapping.py, test_exotic_modems.py, test_events.py,
    test_known_answers_scramblers.py, test_scramblers_packets.py,
    test_named_blocks.py, test_known_answers_r4n.py)."""
    qpsk = psk_constellation(4)
    qam16 = qam_constellation(16)
    r = _rng(0)
    fs_fm = 240_000.0
    t_fm = np.arange(48_000) / fs_fm
    fm_iq = np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(np.sin(2 * np.pi * 1000 * t_fm)) / fs_fm)
    fs_st = 192_000.0
    t_st = np.arange(96_000) / fs_st
    mpx = ((np.sin(2 * np.pi * 800 * t_st) + np.sin(2 * np.pi * 2000 * t_st)) / 2
           + 0.1 * np.sin(2 * np.pi * 19_000 * t_st)
           + (np.sin(2 * np.pi * 800 * t_st) - np.sin(2 * np.pi * 2000 * t_st)) / 2
           * np.sin(2 * np.pi * 38_000 * t_st)
           + 0.3 * np.cos(2 * np.pi * 57_000 * t_st)
           * (2.0 * (np.cumsum(r.integers(0, 2, 600)) % 2)[
               np.minimum((t_st * 1187.5).astype(int), 599)] - 1.0))
    bits16 = r.integers(0, 2, (10, 8))
    im_grid, _ = modem.index_modulation_map(torch.from_numpy(bits16), 8, 2, qpsk)
    qam = ((r.integers(0, 2, (8, 16)) * 2 - 1)
           + 1j * (r.integers(0, 2, (8, 16)) * 2 - 1)).astype(np.complex64) / np.sqrt(2)
    oqam = modem.oqam_stagger(torch.from_numpy(qam)).numpy()
    fbmc = modem.fbmc_modulate(torch.from_numpy(oqam)).numpy()
    nr = modem.NrGridConfig(num_prbs=4)
    rake_code = (2.0 * r.integers(0, 2, 32) - 1.0).astype(np.float32)
    rake_sym = (2.0 * r.integers(0, 2, 20) - 1.0).astype(np.float32)
    rake_tx = (rake_sym[:, None] * rake_code[None, :]).reshape(-1)
    rake_rx = np.zeros(rake_tx.shape[0] + 7, np.complex64)
    rake_rx[: rake_tx.shape[0]] += rake_tx
    rake_rx[7:] += 0.5j * rake_tx
    wdm = [np.repeat(r.standard_normal(32), 64).astype(np.complex64) for _ in range(3)]
    mask = r.random((4, 400)) < 0.25
    frames = r.integers(0, 256, (8, 32))
    pmu = 1.5 * np.cos(2 * np.pi * 50.3 * np.arange(2000) / 1e4 + 0.4)
    harm = np.sin(2 * np.pi * 50 * np.arange(4000) / 1e4) + 0.1 * np.sin(
        2 * np.pi * 150 * np.arange(4000) / 1e4)
    plc_bits = r.integers(0, 2, 40)
    tol, ptol = FAMILY_TOL, FAMILY_PHASE_TOL
    return [
        # ops.filters2 emphasis group and the recursions
        ("filters2.pre_emphasis", filters2.pre_emphasis, ((r.standard_normal(4096),), {}), tol),
        ("filters2.de_emphasis", filters2.de_emphasis, ((r.standard_normal(4096),), {}), tol),
        ("filters2.fm_deemphasis", filters2.fm_deemphasis,
         ((r.standard_normal((3, 4096)), 240e3), {}), tol),
        # ops.modem
        ("modem.quadrature_demod", modem.quadrature_demod, ((fm_iq, 1.0 / 0.8), {}), tol),
        ("modem.frequency_modulate", modem.frequency_modulate,
         ((0.5 * r.standard_normal(2000), 0.8), {}), tol),
        ("modem.phase_modulate", modem.phase_modulate,
         ((np.asarray([0.0, np.pi / 4, -np.pi / 2]), 1.0), {}), tol),
        ("modem.differential_encode", modem.differential_encode,
         ((r.integers(0, 2, 256),), {}), tol),
        ("modem.differential_decode", modem.differential_decode,
         ((r.integers(0, 2, 256),), {}), tol),
        ("modem.diff_phasor", modem.diff_phasor, ((_iq(r, 64),), {}), tol),
        ("modem.msk_modulate", modem.msk_modulate, ((np.asarray([1, 0, 1, 1, 0, 0, 1]), 8), {}),
         tol),
        ("modem.gmsk_modulate", modem.gmsk_modulate, ((r.integers(0, 2, 400), 8), {}), tol),
        ("modem.cpm_modulate", modem.cpm_modulate,
         ((2 * r.integers(0, 2, 64) - 1, 4), {"pulse": "rc", "span": 2}), tol),
        ("modem.sc_fdma", lambda s: modem.sc_fdma_demodulate(
            modem.sc_fdma_modulate(s, 64, 32, 8), 64, 32, 8),
         ((qpsk[r.integers(0, 4, (6, 32))],), {}), tol),
        ("modem.papr_db", modem.papr_db, ((_iq(r, 256),), {}), tol),
        ("modem.papr_reduce_clip_filter", modem.papr_reduce_clip_filter,
         ((_iq(r, 256), 3.0), {"band": 1.0}), tol),
        ("modem.cyclic_prefix", lambda b: modem.remove_cyclic_prefix(
            modem.add_cyclic_prefix(b, 16), 16), ((_iq(r, 4, 64),), {}), tol),
        ("modem.index_modulation_map", lambda b: modem.index_modulation_map(b, 8, 2, qpsk),
         ((bits16,), {}), tol),
        ("modem.index_modulation_demap", lambda g: modem.index_modulation_demap(g, 8, 2, qpsk),
         ((im_grid.numpy() + 0.3 * _iq(r, 10, 8),), {}), tol),
        ("modem.oqam", lambda q: modem.oqam_destagger(modem.oqam_stagger(q)), ((qam,), {}), tol),
        ("modem.fbmc_modulate", modem.fbmc_modulate, ((oqam,), {}), tol),
        ("modem.fbmc_demodulate", lambda x: modem.fbmc_demodulate(x, 16, 16), ((fbmc,), {}), tol),
        ("modem.nr_map", lambda d: modem.nr_demap(modem.nr_map(d, nr), nr),
         ((_iq(r, modem.nr_data_capacity(nr)),), {}), tol),
        # ops.events
        ("events.refractory_trigger", events.refractory_trigger, ((mask, 16), {}), tol),
        ("events.deadtime_runs", events.deadtime_runs, ((mask, 4), {}), tol),
        ("events.masked_indices", events.masked_indices, ((mask[0], 64), {}), tol),
        # ops.mapping
        ("mapping.symbol_map_demap", lambda x: mapping.symbol_demap(
            mapping.symbol_map(x, qam16), qam16), ((r.integers(0, 16, 64),), {}), tol),
        ("mapping.symbol_slicer", mapping.symbol_slicer, ((_iq(r, 64),), {}), tol),
        ("mapping.chunks_to_symbols", lambda b: mapping.chunks_to_symbols(b, qpsk, 2),
         ((r.integers(0, 2, 64),), {}), tol),
        ("mapping.map_bb", mapping.map_bb, ((r.integers(0, 256, 64), np.arange(255, -1, -1)),
                                            {}), tol),
        ("mapping.constellation_receiver", lambda x: mapping.constellation_receiver(x, qpsk),
         ((qpsk[r.integers(0, 4, 500)] + 0.05 * _iq(r, 500),), {}), tol),
        ("mapping.soft_decision_decode", mapping.soft_decision_decode,
         ((np.asarray([5.0, -5.0, 0.1]),), {}), tol),
        ("mapping.vector_quantize", mapping.vector_quantize,
         ((r.standard_normal((64, 2)), r.standard_normal((8, 2))), {}), tol),
        ("mapping.oqpsk", lambda b: mapping.oqpsk_demodulate(mapping.oqpsk_modulate(b)),
         ((r.integers(0, 2, 128),), {}), tol),
        ("mapping.qam_transceiver", lambda b: mapping.qam_transceiver(
            b, 16, 20.0, threefry.key(0)), ((r.integers(0, 2, 4000),), {}), tol),
        ("mapping.am_demod", mapping.am_demod,
         ((1.0 + 0.5 * np.sin(2 * np.pi * 1000 * np.arange(9600) / 48e3),), {}), tol),
        ("mapping.ssb_modulate", lambda a: mapping.ssb_modulate(a, 8000.0),
         ((np.sin(2 * np.pi * 700 * np.arange(8192) / 8000.0),), {}), tol),
        ("mapping.fm_receiver", lambda x: mapping.fm_receiver(x, fs_fm, audio_rate=48e3),
         ((fm_iq,), {}), tol),
        ("mapping.fm_stereo_decode", lambda m: mapping.fm_stereo_decode(m, fs_st),
         ((mpx,), {}), tol),
        ("mapping.rds_subcarrier_demod", lambda m: mapping.rds_subcarrier_demod(m, fs_st),
         ((mpx,), {}), tol),
        ("mapping.ofdm_carrier_allocate", lambda d: mapping.ofdm_carrier_deallocate(
            mapping.ofdm_carrier_allocate(d, 32, [-10, -5, -2, 2, 5, 10], [-7, 7]),
            [-10, -5, -2, 2, 5, 10]), ((_iq(r, 18),), {}), tol),
        ("mapping.multicarrier_waterfill", lambda g: mapping.multicarrier_waterfill(g, 10.0),
         ((np.asarray([1.0, 1.0, 0.01]),), {}), tol),
        ("mapping.pilot_insert", lambda s: mapping.pilot_insert(s, 9 + 0j, 4),
         ((_iq(r, 10),), {}), tol),
        ("mapping.crest_factor_reduce", lambda x: mapping.peak_to_average(
            mapping.crest_factor_reduce(x, 3.0)), ((_iq(r, 4096),), {}), tol),
        ("mapping.incoherent_detect", lambda x: mapping.incoherent_detect(
            x, [500.0, 1000.0, 1500.0, 2000.0], 8000.0, 80)[0], ((_iq(r, 4000),), {}), tol),
        ("mapping.regenerate_bb", lambda m: mapping.regenerate_bb(m, 20, 5, 100),
         ((mask[1, :100],), {}), tol),
        # ops.scramblers
        ("scramblers.additive_scramble", lambda b: scramblers.additive_scramble(
            b, 0b1100000, 0x7F, 7), ((r.integers(0, 2, 500),), {}), tol),
        ("scramblers.pn_scramble", lambda b: scramblers.pn_scramble(b, 0x80004, 0xABCDE, 20),
         ((r.integers(0, 2, 257),), {}), tol),
        ("scramblers.pn_descramble", lambda b: scramblers.pn_descramble(
            b, 0x80004, 0xABCDE, 20), ((r.integers(0, 2, 257),), {}), tol),
        ("scramblers.pn_wide", lambda b: scramblers.pn_scramble(
            b, 0x100000057, 0x1234567890, 33), ((r.integers(0, 2, 120),), {}), tol),
        ("scramblers.lcg_whiten", scramblers.lcg_whiten, ((np.arange(256),), {}), tol),
        ("scramblers.crc16_parallel", scramblers.crc16_parallel, ((frames,), {}), tol),
        ("scramblers.fec_golay", lambda b: scramblers.fec_decode(
            "golay", scramblers.fec_encode("golay", b)), ((r.integers(0, 2, 12),), {}), tol),
        ("scramblers.fec_repetition", lambda b: scramblers.fec_decode(
            "repetition", scramblers.fec_encode("repetition", b)),
         ((r.integers(0, 2, 60),), {}), tol),
        ("scramblers.covert_timing", lambda b: scramblers.covert_timing_decode(
            scramblers.covert_timing_encode(b, 100, 30), 100, 30),
         ((r.integers(0, 2, 64),), {}), tol),
        # ops.spreading RAKE
        ("spreading.rake_search", lambda x, c: spreading.rake_search(x, c, 2, 16),
         ((rake_rx, rake_code), {}), tol),
        ("spreading.rake_combine", lambda x, c: [spreading.rake_combine(
            x, c, *spreading.rake_search(x, c, 2, 16), mode=m) for m in ("mrc", "egc",
                                                                         "selection")],
         ((rake_rx, rake_code), {}), tol),
        # ops.exotic_modems
        ("exotic.jt65", lambda s: (xm.jt65_modulate(s), xm.jt65_demodulate(xm.jt65_modulate(s))),
         ((r.integers(0, 65, 30),), {}), ptol),
        ("exotic.wspr", lambda s: (xm.wspr_modulate(s), xm.wspr_demodulate(xm.wspr_modulate(s))),
         ((r.integers(0, 4, 40),), {}), ptol),
        ("exotic.underwater", lambda b: xm.underwater_demodulate(xm.underwater_modulate(b)),
         ((r.integers(0, 2, 50),), {}), tol),
        ("exotic.plc", lambda b: xm.plc_demodulate(xm.plc_modulate(b)), ((plc_bits,), {}), tol),
        ("exotic.rfid_backscatter_decode", lambda x: xm.rfid_backscatter_decode(x, 40e3, 1e6),
         ((np.repeat(2.0 + np.where(r.integers(0, 2, 32) > 0, 1.0, -1.0), 12)
           .astype(np.complex64),), {}), tol),
        ("exotic.ambient_backscatter_detect", xm.ambient_backscatter_detect,
         ((1.0 + 0.3 * np.repeat([1, 0, 1, 1, 0], 64) + 0.02 * r.standard_normal(320),), {}),
         tol),
        ("exotic.vlc", lambda b: (xm.vlc_demodulate(xm.vlc_modulate(b)),
                                  xm.vlc_modulate(b, 16, "vppm", 0.25)),
         ((r.integers(0, 2, 64),), {}), tol),
        ("exotic.coherent_optical_receive", lambda x: decisive(
            *xm.coherent_optical_receive(x, qpsk), qpsk),
         ((qpsk[r.integers(0, 4, 3000)] * np.exp(1j * 0.6) * 3.0,), {}), tol),
        ("exotic.wdm", lambda c: xm.wdm_demux(xm.wdm_mux(c), 3), ((wdm,), {}), tol),
        ("exotic.photonic_mzi_transfer", xm.photonic_mzi_transfer,
         ((np.linspace(0, np.pi, 16),), {}), tol),
        ("exotic.dab", lambda b: xm.dab_symbol_demodulate(
            xm.dab_symbol_modulate(b, 64, 128)[0], 64, 128), ((r.integers(0, 2, 512),), {}), tol),
        ("exotic.pmu_phasor", lambda v: xm.pmu_phasor(v, 1e4, 50.0), ((pmu,), {}),
         FAMILY_DFT_TOL),
        ("exotic.harmonics_analyze", lambda v: xm.harmonics_analyze(v, 1e4, 50.0),
         ((harm,), {}), FAMILY_DFT_TOL),
        ("exotic.industrial_4_20ma", lambda v: xm.industrial_4_20ma_decode(
            xm.industrial_4_20ma_encode(v, 0.0, 100.0), 0.0, 100.0),
         ((np.asarray([0.0, 50.0, 100.0]),), {}), tol),
    ]


def _conv_packet(device: torch.device) -> dict:
    """The FEC table's convolutional codec on a 1,500-byte packet, hard
    decisions: each Viterbi kernel launched once on the card."""
    bits = _rng(1500).integers(0, 2, 8 * PACKET_BYTES).astype(np.int32)
    coded = scramblers.fec_encode("convolutional", torch.from_numpy(bits).to(device))
    before = launch_counts()
    decoded = scramblers.fec_decode("convolutional", coded)
    launches = _launched(before)
    ok = bool(np.array_equal(decoded.cpu().numpy(), bits))
    return {"ok": ok, "bits": int(bits.shape[0]), "coded": int(coded.shape[-1]),
            "launches": {k: launches[k] for k in ("viterbi_forward", "viterbi_traceback")}}


def _lte_subframe(device: torch.device) -> dict:
    """An LTE 20 MHz uplink subframe through SC-FDMA and back: QPSK on 1200
    subcarriers of a 2048-point transform, cp 144, 14 blocks; its PAPR
    against plain OFDM on the same symbols."""
    sym = psk_constellation(4)[_rng(20).integers(0, 4, (LTE_SYMBOLS, LTE_SC))]
    s = torch.from_numpy(sym).to(device)
    tx = modem.sc_fdma_modulate(s, LTE_FFT, LTE_SC, LTE_CP)
    back = modem.sc_fdma_demodulate(tx, LTE_FFT, LTE_SC, LTE_CP)
    err = float(torch.max(torch.abs(back - s)))
    grid = torch.zeros((LTE_SYMBOLS, LTE_FFT), dtype=IQ_DTYPE, device=device)
    grid[:, :LTE_SC] = s
    ofdm = torch.fft.ifft(grid, dim=-1).reshape(-1)
    papr_sc, papr_ofdm = float(modem.papr_db(tx)), float(modem.papr_db(ofdm))
    return {"ok": err < LTE_TOL and papr_sc < papr_ofdm, "max_abs_err": err,
            "papr_sc_fdma_db": papr_sc, "papr_ofdm_db": papr_ofdm, "samples": int(tx.shape[-1])}


def modem_family_gate(device=DEFAULT_DEVICE) -> dict:
    """Every case of `_family_cases` on `device` and on the CPU (worst
    difference per case, inf for differing decisions; each held to its
    tolerance),
    then the 1,500-byte convolutional packet and the LTE subframe on
    `device`. ``aes_ctr_keystream_xor`` is left out: it is a host function
    of bytes, and the ``cryptography`` package it needs is not on every
    machine. Returns ``ok``, ``worst`` by case, ``conv_packet``, ``lte`` and
    ``left_out``."""
    device = resolve_device(device)
    cpu = torch.device("cpu")
    worst, failed = {}, []
    for name, fn, (args, kwargs), tol in _family_cases():
        got = fn(*_on(list(args), device), **kwargs)
        want = fn(*_on(list(args), cpu), **kwargs)
        worst[name] = compare(got, want)
        if not worst[name] <= tol:
            failed.append(name)
    conv = _conv_packet(device)
    lte = _lte_subframe(device)
    ok = not failed and conv["ok"] and lte["ok"]
    return {"ok": ok, "worst": worst, "failed": failed, "conv_packet": conv, "lte": lte,
            "left_out": {"scramblers.aes_ctr_keystream_xor":
                         "host function of bytes; needs the cryptography package"},
            "device": str(device)}
