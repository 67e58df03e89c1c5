"""The packets, protocols, ADS-B, audio and applied slice's two gates: a
narrowband-FM (NBFM) dispatch monitor at full width, and the slice's
blocks card against CPU.

`dispatch_monitor_gate(device)` builds an 8.0 s capture at 2.4 MS/s (an
RTL-SDR's rate) in numpy from seed 0 (`dispatch_scene`, phases in
float64): complex AWGN at 15 dB of carrier-to-noise in 12.5 kHz for a
unit carrier, and eight FM channels on the 12.5 kHz raster (CHANNELS):
voice with CTCSS tones, a DTMF ANI, a POCSAG pager, a carrier-squelch
user, two idle channels and a stuck carrier. The capture is handed over in
ROWS rows of BLOCK samples, each row led by the LEAD samples before it
(zeros before the first), and runs through the monitor's chain
(`dispatch_monitor_chain`), made of the port's functions only:

1. Channelise: `stream_math.digital_down_convert` by 10 on the rows, one
   `nco_mix` and one `fir_decimate` launch a channel. A row's first
   LEAD/10 outputs are dropped and the rest rotated by the oscillator's
   phase at the row's first sample (float64, wrapped), so the rows join
   into the stream a DDC of the whole capture gives (`join_rows`).
2. Select and demodulate: `filters.decimating_fir` with
   `design_lowpass(255, 6250, 240e3)` by 10 on the joined channels (one
   launch), `modem.quadrature_demod` scaled to the voice deviation, and
   `design_lowpass(63, 3400, 24e3)` by 3 to 8 kS/s audio (one launch).
3. Squelch: `stream_blocks.power_squelch` on the 24 kS/s channel IQ (one
   launch of the recursion kernel, kind ``ema``); its open intervals are
   the transmissions.
4. Tone: `protocols.ctcss_detect` on every channel's 1 s windows in one
   call.
5. Dial: `audio.dtmf_detect` on channel C's audio over the ANI window
   (ANI_WINDOW_S from each opening, when the ANI is sent).
6. Page: channel D's discriminator at 20 samples a bit, timed from the
   preamble, sliced by the sign of each bit's mean, searched for the sync
   word, each batch through `packets.pocsag_decode` (host numpy glue).
7. Voice: each transmission of A, B and F, counted from its opening,
   through the 300-3,000 Hz `design_bandpass(127)` (one launch for all),
   then `audio.voice_restore` and `applied.spectral_subtraction`, and
   `audio.pitch_track` on the band-passed voice.

`dispatch_bars` holds the result to the scene's truth;
`dispatch_agreement` holds a card run against a CPU run of the same rows.

`protocol_blocks_gate(device)` runs every `BLOCKS` entry of `packets` and
`audio` and every public function of `protocols`, `applied` and `adsb` on
their JAX tests' inputs on `device` and on the CPU: decisions equal,
floats within the stated tolerance, the worst case by name.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import tempfile
import time

import numpy as np
import torch

from r4w_tpu_torch import adsb
from r4w_tpu_torch.core.types import DEFAULT_DEVICE, resolve_device
from r4w_tpu_torch.modem_gates import _Stages, _launched, _on, _synchronize, compare, launch_counts
from r4w_tpu_torch.ops import applied as ap
from r4w_tpu_torch.ops import audio as au
from r4w_tpu_torch.ops import filters
from r4w_tpu_torch.ops import packets as pk
from r4w_tpu_torch.ops import protocols as pr
from r4w_tpu_torch.ops.modem import quadrature_demod
from r4w_tpu_torch.ops.stream_blocks import power_squelch
from r4w_tpu_torch.ops.stream_math import digital_down_convert

CAPTURE_RATE_HZ = 2.4e6              # an RTL-SDR capture
BLOCK = 960_000                      # samples a row (0.4 s), a multiple of 10 · 10 · 3
ROWS = 20                            # 8.0 s, 154 MB of complex64
DDC_DECIMATION = 10                  # 240 kS/s channels
DDC_TAPS = 63                        # the DDC's default lowpass
LEAD = 70                            # K − 1 = 62 samples of FIR history, to a multiple of 10
CHANNEL_RATE_HZ = CAPTURE_RATE_HZ / DDC_DECIMATION
SELECT_TAPS, SELECT_CUTOFF_HZ, SELECT_DECIMATION = 255, 6250.0, 10
IF_RATE_HZ = CHANNEL_RATE_HZ / SELECT_DECIMATION       # 24 kS/s
AUDIO_TAPS, AUDIO_CUTOFF_HZ, AUDIO_DECIMATION = 63, 3400.0, 3
AUDIO_RATE_HZ = IF_RATE_HZ / AUDIO_DECIMATION          # 8 kS/s
VOICE_TAPS, VOICE_LO_HZ, VOICE_HI_HZ = 127, 300.0, 3000.0
CNR_DB, CHANNEL_BW_HZ = 15.0, 12.5e3
VOICE_DEVIATION_HZ = 2500.0          # peak, at full scale
CTCSS_LEVEL = 0.15                   # of full scale
SPEECH_RMS = 0.4                     # the voice before the transmitter's deviation limiter
VOICE_PEAK = 0.85                    # the limiter's ceiling, so voice + tone stays within full scale
MIC_NOISE_RMS = 0.1                  # the mic's background, in the radio's audio band
LEAD_IN_S = 0.3                      # mic noise before speech in every transmission
FORMANTS_HZ = ((700.0, 80.0), (1220.0, 90.0), (2600.0, 120.0))   # (centre, bandwidth)
SYLLABLE_HZ = 4.0
F0_WOBBLE_HZ = 0.7                   # f0(t) = f0 + dev·sin(2π·0.7·t)
SCENE_AUDIO_RATE_HZ = 48e3           # the transmitters' audio, 50 capture samples a sample
POCSAG_BAUD, POCSAG_DEVIATION_HZ = 1200.0, 4500.0
POCSAG_PREAMBLE_BITS = 576
POCSAG_SYNC = 0x7CD215D8
POCSAG_GUARD_S = 0.02                # carrier before the preamble
DTMF_LEVEL = 0.85
# the monitor
SQUELCH_ALPHA = 0.01                 # 4.2 ms at 24 kS/s
SQUELCH_DB = -7.5                    # between the channel's noise (−15 dB) and a carrier (0 dB)
TONE_WINDOW_S = 1.0
ANI_WINDOW_S = 1.25                  # the DTMF decoder listens this long after an opening
SAMPLES_PER_BIT = int(IF_RATE_HZ / POCSAG_BAUD)        # 20
TIMING_BITS = (48, 480)              # preamble bits after an opening that set the bit timing
# bars
EDGE_TOL_S = 0.02
MAX_IDLE_FALSE_TONES = 2             # of the 16 windows of E and G (no carrier)
# On a carrier with no tone (F, H) the discriminator's noise rises with f²
# across the bank, and the max/mean statistic passes 8 in ~31% of windows
# (white noise: ~3.5%; tests/test_torch_dispatch_monitor.py measures
# both): the false tones there are at most the 99th percentile of that
# count, each among the bank's upper tones, where the f² noise puts them.
CARRIER_FALSE_RATE = 0.31
CARRIER_FALSE_MIN_HZ = 131.8
LEAD_DROP_DB = {"voice_restore": 15.0, "spectral_subtraction": 12.0}
SPEECH_MOVE_DB = 3.0
PITCH_TOL, PITCH_SHARE, PITCH_STRENGTH = 0.05, 0.8, 0.5
PITCH_FRAME, PITCH_HOP = 1024, 512
LEAD_WINDOW_S = (0.05, 0.25)         # the lead-in's level, from the opening
SPEECH_GUARD_S = (0.15, 0.1)         # the speech's level: after speech starts, before the close
# card against CPU
AUDIO_TOL = 1e-4                     # max|card − CPU| / RMS(CPU) of the audio while the squelch is open
IQ_TOL = 1e-5                        # max|card − CPU| / max|CPU| of the channels
VOICE_TOL = 1e-4                     # the cleaned voice, relative to its peak


@dataclasses.dataclass(frozen=True)
class Channel:
    """One 12.5 kHz channel of the scene: its offset from the capture's
    centre, what it carries and when it is keyed ((start, stop) seconds)."""

    name: str
    offset_hz: float
    kind: str                                  # voice | pocsag | carrier | idle
    keyed: tuple = ()
    f0_hz: tuple = (200.0, 20.0)               # (mean, wobble) of the voice's pitch
    ctcss_hz: float | None = None
    ani: str | None = None                     # DTMF digits sent at `ani_at`
    ani_at: float = 0.0
    speech_at: tuple | None = None             # speech start in each keyed interval
    pages: tuple = ()                          # (address, function, digits) a batch each


CHANNELS = (
    Channel("A", -875.0e3, "voice", ((0.5, 4.3), (5.1, 7.6)), (200.0, 20.0), 103.5),
    Channel("B", -512.5e3, "voice", ((1.2, 6.8),), (150.0, 15.0), 131.8),
    Channel("C", -250.0e3, "voice", ((0.4, 3.5),), (200.0, 20.0), 156.7, "5551234", 0.6, (1.7,)),
    Channel("D", -25.0e3, "pocsag", ((2.0, 4.4),), pages=(
        (1234567, 0, "911"), (2000001, 1, "5550100"), (524290, 2, "12-34"),
        (1048579, 3, "0425"))),
    Channel("E", 100.0e3, "idle"),
    Channel("F", 362.5e3, "voice", ((3.0, 7.0),), (200.0, 20.0)),
    Channel("G", 612.5e3, "idle"),
    Channel("H", 850.0e3, "carrier", ((0.0, ROWS * BLOCK / CAPTURE_RATE_HZ),)),
)
TONE_CHANNELS = ("A", "B", "C")
IDLE_CHANNELS = ("E", "G")
CARRIER_NO_TONE_CHANNELS = ("F", "H")
VOICE_CHANNELS = ("A", "B", "F")
DIAL_CHANNEL, PAGE_CHANNEL = "C", "D"


def _speech_starts(ch: Channel) -> tuple:
    return ch.speech_at or tuple(t0 + LEAD_IN_S for t0, _ in ch.keyed)


def _band_mask(n: int, rate: float) -> np.ndarray:
    """The radio's audio filter: the 300-3,000 Hz band of an n-point rfft."""
    f = np.fft.rfftfreq(n, 1.0 / rate)
    return ((f >= VOICE_LO_HZ) & (f <= VOICE_HI_HZ)).astype(np.float64)


def _voice_track(ch: Channel, n: int, rng: np.random.Generator) -> np.ndarray:
    """(speech, mic noise) at SCENE_AUDIO_RATE_HZ over the whole capture:
    a glottal pulse train at the f0 contour through three formant
    resonators under a 4 Hz syllabic envelope, band-limited to the radio's
    300-3,000 Hz, scaled to SPEECH_RMS, through a soft limiter at VOICE_PEAK
    (a radio's instantaneous deviation control) and band-limited again (its
    post-limiter filter), peak VOICE_PEAK; the mic noise white,
    band-limited the same way and scaled to MIC_NOISE_RMS."""
    fs = SCENE_AUDIO_RATE_HZ
    t = np.arange(n) / fs
    f0 = ch.f0_hz[0] + ch.f0_hz[1] * np.sin(2 * np.pi * F0_WOBBLE_HZ * t)
    cycles = np.cumsum(f0 / fs)
    pulses = np.diff(np.floor(cycles), prepend=0.0)
    w = 2 * np.pi * np.fft.rfftfreq(n, 1.0 / fs) / fs
    z = np.exp(-1j * w)
    response = np.ones_like(z)
    for centre, bw in FORMANTS_HZ:
        r = math.exp(-math.pi * bw / fs)
        response /= 1.0 - 2.0 * r * math.cos(2 * math.pi * centre / fs) * z + r * r * z * z
    band = _band_mask(n, fs)
    speech = np.fft.irfft(np.fft.rfft(pulses) * response * band, n)
    speech *= 0.55 + 0.45 * np.sin(2 * np.pi * SYLLABLE_HZ * t)
    speech *= SPEECH_RMS / np.sqrt(np.mean(speech ** 2))
    # the deviation limiter, then the radio's audio filter again: the
    # limiter's intermodulation puts energy back at f0, under 300 Hz
    speech = np.fft.irfft(np.fft.rfft(VOICE_PEAK * np.tanh(speech / VOICE_PEAK)) * band, n)
    speech *= VOICE_PEAK / np.max(np.abs(speech))
    noise = np.fft.irfft(np.fft.rfft(rng.standard_normal(n)) * band, n)
    noise *= MIC_NOISE_RMS / np.sqrt(np.mean(noise ** 2))
    return speech, noise


def _pocsag_bits(pages) -> np.ndarray:
    """The preamble (1010…) and one batch a page, MSB first."""
    words = np.concatenate([pk.pocsag_encode_numeric(a, d, f) for a, f, d in pages])
    bits = ((words[:, None] >> np.arange(31, -1, -1, dtype=np.uint32)) & 1).reshape(-1)
    return np.concatenate([np.arange(POCSAG_PREAMBLE_BITS) % 2 == 0, bits]).astype(np.int64)


def _frequency_track(ch: Channel, n: int, rng: np.random.Generator) -> np.ndarray:
    """The channel's instantaneous frequency offset (Hz) at
    SCENE_AUDIO_RATE_HZ over the capture's span."""
    fs = SCENE_AUDIO_RATE_HZ
    t = np.arange(n) / fs
    keyed = np.zeros(n, bool)
    for t0, t1 in ch.keyed:
        keyed |= (t >= t0) & (t < t1)
    if ch.kind == "pocsag":
        bits = _pocsag_bits(ch.pages)
        start = ch.keyed[0][0] + POCSAG_GUARD_S
        k = np.floor((t - start) * POCSAG_BAUD).astype(np.int64)
        on = (k >= 0) & (k < bits.size)
        # a 1 is the lower tone
        return np.where(on, np.where(bits[np.clip(k, 0, bits.size - 1)] == 1,
                                     -POCSAG_DEVIATION_HZ, POCSAG_DEVIATION_HZ), 0.0)
    if ch.kind != "voice":
        return np.zeros(n)
    speech, noise = _voice_track(ch, n, rng)
    talking = np.zeros(n, bool)
    for (t0, t1), s0 in zip(ch.keyed, _speech_starts(ch)):
        talking |= (t >= s0) & (t < t1)
    m = np.where(talking, speech, 0.0) + np.where(keyed, noise, 0.0)
    if ch.ani:
        dial = au.dtmf_generate(ch.ani, fs, device="cpu").numpy().astype(np.float64)
        a = int(round(ch.ani_at * fs))
        m[a:a + dial.size] += DTMF_LEVEL * dial[: max(0, n - a)]
    if ch.ctcss_hz:
        m += np.where(keyed, CTCSS_LEVEL * np.sin(2 * np.pi * ch.ctcss_hz * t), 0.0)
    return VOICE_DEVIATION_HZ * m


def noise_sigma() -> float:
    """Per-component σ of the capture's AWGN: a unit carrier CNR_DB over
    the noise in CHANNEL_BW_HZ."""
    n0 = 1.0 / (10.0 ** (CNR_DB / 10.0) * CHANNEL_BW_HZ)
    return math.sqrt(n0 * CAPTURE_RATE_HZ / 2.0)


def dispatch_scene(rows: int = ROWS, channels=CHANNELS):
    """(capture rows (rows, LEAD + block) complex64, truth): the capture at
    CAPTURE_RATE_HZ made in numpy from seed 0, row by row, each row led by
    the LEAD samples before it (zeros before the first). The transmitters'
    content spans the channels' keyed intervals whatever `rows` is, so the
    first rows of a longer scene are the rows of a shorter one."""
    fs, block = CAPTURE_RATE_HZ, BLOCK
    rng = np.random.default_rng(0)
    span_s = max([t1 for ch in channels for _, t1 in ch.keyed] + [rows * block / fs])
    n_audio = int(math.ceil(span_s * SCENE_AUDIO_RATE_HZ)) + 2
    up = fs / SCENE_AUDIO_RATE_HZ
    tracks = {}
    for ch in channels:
        if not ch.keyed:
            continue
        freq = _frequency_track(ch, n_audio, rng)
        # the phase at the audio samples; linear between them (the
        # frequency held over each audio sample)
        phase = np.concatenate([[0.0], np.cumsum(2 * np.pi * freq / SCENE_AUDIO_RATE_HZ)])
        tracks[ch.name] = (phase, rng.uniform(0.0, 2 * np.pi))
    sigma = noise_sigma()
    cap = np.zeros((rows, LEAD + block), np.complex64)
    for r in range(rows):
        k = np.arange(r * block, (r + 1) * block)
        blk = (sigma * (rng.standard_normal(block) + 1j * rng.standard_normal(block)))
        t = k / fs
        for ch in channels:
            if ch.name not in tracks:
                continue
            keyed = np.zeros(block, bool)
            for t0, t1 in ch.keyed:
                keyed |= (t >= t0) & (t < t1)
            if not keyed.any():
                continue
            phase, phase0 = tracks[ch.name]
            mod = np.interp(k / up, np.arange(phase.size), phase)
            carrier = 2 * np.pi * ((k * (ch.offset_hz / fs)) % 1.0)
            blk += np.where(keyed, np.exp(1j * (carrier + mod + phase0)), 0.0)
        cap[r, LEAD:] = blk
        if r:
            cap[r, :LEAD] = cap[r - 1, -LEAD:]
    return cap, {"rows": rows, "block": block, "channels": channels}


# ------------------------------------------------------------- the chain


def row_rotation(offset_hz: float, rows: int, device, block: int = BLOCK) -> torch.Tensor:
    """(rows,) complex64: the down-converter's oscillator at each row's
    first sample, r·block − LEAD, in float64 and wrapped: a row mixed from
    phase 0 times this is the whole capture's mix."""
    k0 = np.arange(rows) * block - LEAD
    phase = -2 * np.pi * ((k0 * (offset_hz / CAPTURE_RATE_HZ)) % 1.0)
    return torch.from_numpy(np.exp(1j * phase).astype(np.complex64)).to(device)


def join_rows(y: torch.Tensor, offset_hz: float, block: int = BLOCK) -> torch.Tensor:
    """A DDC's (rows, (LEAD + block)/f) outputs as one stream: each row's
    first LEAD/f outputs (which only fill the FIR) dropped, the rest
    rotated to the whole capture's oscillator phase."""
    rows = y.shape[0]
    kept = y[:, LEAD // DDC_DECIMATION:]
    return (kept * row_rotation(offset_hz, rows, y.device, block)[:, None]).reshape(-1)


def channelise(capture: torch.Tensor, channels=CHANNELS) -> torch.Tensor:
    """(channels, rows·block/10) complex64 at CHANNEL_RATE_HZ: one DDC (one
    NCO and one FIR launch) a channel on the rows, joined without a seam."""
    block = capture.shape[-1] - LEAD
    return torch.stack([join_rows(digital_down_convert(
        capture, ch.offset_hz, CAPTURE_RATE_HZ, DDC_DECIMATION), ch.offset_hz, block)
        for ch in channels])


def _intervals(mask: np.ndarray) -> list:
    """[start, stop) runs of True in a 1-D mask."""
    d = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    return list(zip(np.flatnonzero(d == 1).tolist(), np.flatnonzero(d == -1).tolist()))


def slice_bits(fm: np.ndarray) -> np.ndarray:
    """POCSAG bits from a discriminator at SAMPLES_PER_BIT samples a bit,
    starting within the preamble: the bit timing is the phase whose bit
    means over TIMING_BITS of the preamble are largest in magnitude; a bit
    is 1 where its mean is negative (the lower tone)."""
    spb = SAMPLES_PER_BIT
    lo, hi = TIMING_BITS
    best, best_score = 0, -1.0
    for p in range(spb):
        seg = fm[p + lo * spb:p + hi * spb]
        means = seg[: (seg.size // spb) * spb].reshape(-1, spb).mean(axis=1)
        score = float(np.mean(np.abs(means)))
        if score > best_score:
            best, best_score = p, score
    seg = fm[best:]
    means = seg[: (seg.size // spb) * spb].reshape(-1, spb).mean(axis=1)
    return (means < 0).astype(np.int64)


def find_batches(bits: np.ndarray) -> np.ndarray:
    """(batches, 17) uint32 words: every exact match of the sync codeword
    and the 16 words after it, searched past each batch found."""
    sync = (POCSAG_SYNC >> np.arange(31, -1, -1)) & 1
    weights = np.uint64(1) << np.arange(31, -1, -1, dtype=np.uint64)
    out, i = [], 0
    n = bits.size
    while i + 17 * 32 <= n:
        if np.array_equal(bits[i:i + 32], sync):
            chunk = bits[i:i + 17 * 32].reshape(17, 32).astype(np.uint64)
            out.append((chunk * weights).sum(axis=1).astype(np.uint32))
            i += 17 * 32
        else:
            i += 1
    return np.asarray(out, np.uint32).reshape(-1, 17)


def _db(x: torch.Tensor) -> float:
    return float(10.0 * torch.log10(torch.mean(x.double() ** 2)))


def dispatch_monitor_chain(capture: torch.Tensor, channels=CHANNELS) -> dict:
    """The monitor on (rows, LEAD + block) capture rows, each stage's
    milliseconds (CUDA events on the card) in ``stage_ms``."""
    dev = capture.device
    names = [ch.name for ch in channels]
    stages = _Stages(dev)
    stages.mark("start")
    chans = channelise(capture, channels)
    stages.mark("channelise")
    iq = filters.decimating_fir(filters.design_lowpass(
        SELECT_TAPS, SELECT_CUTOFF_HZ, CHANNEL_RATE_HZ), chans, SELECT_DECIMATION)[0]
    stages.mark("select")
    gated, _ = power_squelch(iq, SQUELCH_DB, SQUELCH_ALPHA)
    open_mask = gated != 0
    stages.mark("squelch")
    fm = quadrature_demod(iq, IF_RATE_HZ / (2 * math.pi * VOICE_DEVIATION_HZ))
    audio = filters.decimating_fir(filters.design_lowpass(
        AUDIO_TAPS, AUDIO_CUTOFF_HZ, IF_RATE_HZ), fm, AUDIO_DECIMATION)[0]
    stages.mark("demodulate")
    w = int(TONE_WINDOW_S * AUDIO_RATE_HZ)
    n_win = audio.shape[-1] // w
    tones, metrics = pr.ctcss_detect(audio[:, : n_win * w].reshape(len(names), n_win, w),
                                     AUDIO_RATE_HZ)
    stages.mark("tone")
    open_h = open_mask.cpu().numpy()
    opened = {n: _intervals(open_h[i]) for i, n in enumerate(names)}
    dial = {}
    if DIAL_CHANNEL in names:
        i = names.index(DIAL_CHANNEL)
        for start, _ in opened[DIAL_CHANNEL]:
            a0 = -(-start // AUDIO_DECIMATION)
            dial[start] = au.dtmf_detect(audio[i, a0:a0 + int(ANI_WINDOW_S * AUDIO_RATE_HZ)],
                                         AUDIO_RATE_HZ)
    stages.mark("dial")
    pages = []
    if PAGE_CHANNEL in names:
        i = names.index(PAGE_CHANNEL)
        fm_h = fm[i].cpu().numpy()
        for start, stop in opened[PAGE_CHANNEL]:
            words = find_batches(slice_bits(fm_h[start:stop]))
            if not len(words):
                continue
            addr, func, nib, valid = pk.pocsag_decode(
                torch.from_numpy(words.astype(np.int64)).to(dev))
            for j in range(words.shape[0]):
                pages.append((int(addr[j]), int(func[j]), pk.pocsag_digits_to_str(nib[j], valid[j])))
    stages.mark("page")
    voice = _voice_stage(audio, names, opened)
    stages.mark("voice")
    return {"names": names, "channels": chans, "iq": iq, "open": open_mask, "opened": opened,
            "fm": fm, "audio": audio, "tones": tones, "metrics": metrics, "dial": dial,
            "pages": pages, "voice": voice, "stage_ms": stages.ms()}


def _voice_stage(audio: torch.Tensor, names: list, opened: dict) -> list:
    """Each transmission of the voice channels from its opening: band-passed
    (one FIR launch for all, the segments zero-padded to one length), then
    restored, spectrally subtracted and pitch-tracked, one call each."""
    segs = []
    for name in VOICE_CHANNELS:
        if name not in names:
            continue
        i = names.index(name)
        for start, stop in opened[name]:
            a0, a1 = -(-start // AUDIO_DECIMATION), stop // AUDIO_DECIMATION
            if a1 - a0 >= PITCH_FRAME:
                segs.append((name, start, stop, audio[i, a0:a1]))
    if not segs:
        return []
    length = max(s[3].shape[-1] for s in segs)
    batch = torch.stack([torch.nn.functional.pad(s[3], (0, length - s[3].shape[-1]))
                         for s in segs])
    bp = filters.fir_apply(filters.design_bandpass(VOICE_TAPS, VOICE_LO_HZ, VOICE_HI_HZ,
                                                   AUDIO_RATE_HZ), batch)
    out = []
    for (name, start, stop, seg), row in zip(segs, bp):
        x = row[: seg.shape[-1]]
        f0, strength = au.pitch_track(x, AUDIO_RATE_HZ, PITCH_FRAME, PITCH_HOP)
        out.append({"name": name, "start": start, "stop": stop, "bandpassed": x,
                    "restored": au.voice_restore(x, AUDIO_RATE_HZ),
                    "subtracted": ap.spectral_subtraction(x), "f0": f0, "strength": strength})
    return out


# ------------------------------------------------------------------ bars


def _window_inside(w: int, keyed) -> bool:
    return any(t0 <= w * TONE_WINDOW_S and (w + 1) * TONE_WINDOW_S <= t1 for t0, t1 in keyed)


def _window_overlaps(w: int, keyed) -> bool:
    return any(t0 < (w + 1) * TONE_WINDOW_S and w * TONE_WINDOW_S < t1 for t0, t1 in keyed)


def binomial_quantile(n: int, p: float, q: float) -> int:
    """The least k with P(Binomial(n, p) ≤ k) ≥ q."""
    total = 0.0
    for k in range(n + 1):
        total += math.comb(n, k) * p ** k * (1 - p) ** (n - k)
        if total >= q:
            return k
    return n


def planted_f0(ch: Channel, t: np.ndarray) -> np.ndarray:
    return ch.f0_hz[0] + ch.f0_hz[1] * np.sin(2 * np.pi * F0_WOBBLE_HZ * t)


def voice_levels(v: dict, ch: Channel) -> dict:
    """Lead-in and speech levels (dB) of the band-passed voice and of both
    cleaners' outputs, and the pitch frames: planted f0 at each frame's
    centre, the frames wholly inside the speech."""
    fs = AUDIO_RATE_HZ
    t_open = v["start"] / IF_RATE_HZ
    a0 = -(-v["start"] // AUDIO_DECIMATION)
    n = v["bandpassed"].shape[-1]
    speech_t0 = min((s for s in _speech_starts(ch) if s >= t_open - EDGE_TOL_S),
                    default=t_open + LEAD_IN_S)
    lead = slice(int(LEAD_WINDOW_S[0] * fs), int(LEAD_WINDOW_S[1] * fs))
    s0 = int(round((speech_t0 - a0 / fs + SPEECH_GUARD_S[0]) * fs))
    speech = slice(s0, n - int(SPEECH_GUARD_S[1] * fs))
    res = {"name": v["name"], "open_s": t_open, "close_s": v["stop"] / IF_RATE_HZ}
    x = v["bandpassed"]
    for key in ("restored", "subtracted"):
        y = v[key][..., :n]
        res[f"{key}_lead_drop_db"] = _db(x[lead]) - _db(y[lead])
        res[f"{key}_speech_move_db"] = _db(y[speech]) - _db(x[speech])
    f0 = v["f0"].cpu().numpy()
    strength = v["strength"].cpu().numpy()
    starts = np.arange(f0.size) * PITCH_HOP + a0
    inside = (starts / fs >= speech_t0) & ((starts + PITCH_FRAME) / fs <= v["stop"] / IF_RATE_HZ)
    strong = inside & (strength >= PITCH_STRENGTH)
    truth = planted_f0(ch, (starts + PITCH_FRAME / 2) / fs)
    good = strong & (np.abs(f0 - truth) <= PITCH_TOL * truth)
    res.update(pitch_frames=int(strong.sum()), pitch_good=int(good.sum()),
               pitch_frames_passing=np.flatnonzero(good).tolist())
    return res


def dispatch_bars(out: dict, truth: dict) -> dict:
    """The gate's bars against the scene's truth: every keyed interval of
    A-D, F and H matched by one open interval with both edges within
    EDGE_TOL_S, nothing else open, E and G closed; the planted CTCSS tone on
    A, B and C in every window wholly inside a keyed interval; at most
    MAX_IDLE_FALSE_TONES windows with a tone on the idle E and G; on F and
    H (a carrier, no tone) no more tones than a carrier's f² noise explains
    (`binomial_quantile` of the windows they key at CARRIER_FALSE_RATE),
    each at CARRIER_FALSE_MIN_HZ or above; the ANI read as the JAX
    composition reads it (EXPECTED_ANI); every page's
    address, function and digits; both cleaners' lead-in drops and speech
    moves, and the pitch within PITCH_TOL in PITCH_SHARE of the strong
    frames of every transmission."""
    channels = {ch.name: ch for ch in truth["channels"]}
    names = out["names"]
    span_s = truth["rows"] * truth["block"] / CAPTURE_RATE_HZ
    res, ok = {"squelch": {}}, True
    for name in names:
        ch = channels[name]
        got = [(a / IF_RATE_HZ, b / IF_RATE_HZ) for a, b in out["opened"][name]]
        want = [(t0, min(t1, span_s)) for t0, t1 in ch.keyed if t0 < span_s]
        res["squelch"][name] = [(round(a, 4), round(b, 4)) for a, b in got]
        ok &= len(got) == len(want) and all(
            abs(a - w0) <= EDGE_TOL_S and abs(b - w1) <= EDGE_TOL_S
            for (a, b), (w0, w1) in zip(got, want))
    tones = out["tones"].cpu().numpy()
    res["tones"] = {n: tones[i].tolist() for i, n in enumerate(names)}
    res["tone_windows_checked"] = 0
    for name in TONE_CHANNELS:
        if name not in names:
            continue
        i, ch = names.index(name), channels[name]
        for w in range(tones.shape[1]):
            if _window_inside(w, ch.keyed):
                res["tone_windows_checked"] += 1
                ok &= bool(tones[i, w] == np.float32(ch.ctcss_hz))
    false = {n: np.flatnonzero(tones[names.index(n)] != -1.0).tolist()
             for n in IDLE_CHANNELS + CARRIER_NO_TONE_CHANNELS if n in names}
    res["false_tones"] = false
    ok &= sum(len(false[n]) for n in IDLE_CHANNELS if n in false) <= MAX_IDLE_FALSE_TONES
    carrier_windows = sum(sum(_window_overlaps(w, channels[n].keyed)
                              for w in range(tones.shape[1]))
                          for n in CARRIER_NO_TONE_CHANNELS if n in names)
    res["carrier_false_bound"] = binomial_quantile(carrier_windows, CARRIER_FALSE_RATE, 0.99)
    ok &= sum(len(false[n]) for n in CARRIER_NO_TONE_CHANNELS if n in false) <= res[
        "carrier_false_bound"]
    ok &= all(tones[names.index(n), w] >= np.float32(CARRIER_FALSE_MIN_HZ)
              for n in CARRIER_NO_TONE_CHANNELS if n in false for w in false[n])
    if DIAL_CHANNEL in names:
        res["dial"] = list(out["dial"].values())
        ok &= res["dial"][:1] == [EXPECTED_ANI]
    if PAGE_CHANNEL in names:
        sent = [tuple(p) for p in channels[PAGE_CHANNEL].pages]
        res["pages"] = out["pages"]
        ok &= [(a, f, d) for a, f, d in out["pages"]] == [(a, f, d) for a, f, d in sent]
    res["voice"] = [voice_levels(v, channels[v["name"]]) for v in out["voice"]]
    want_tx = sum(len(channels[n].keyed) for n in VOICE_CHANNELS if n in names)
    ok &= len(res["voice"]) == want_tx
    for v in res["voice"]:
        ok &= v["restored_lead_drop_db"] >= LEAD_DROP_DB["voice_restore"]
        ok &= v["subtracted_lead_drop_db"] >= LEAD_DROP_DB["spectral_subtraction"]
        ok &= abs(v["restored_speech_move_db"]) <= SPEECH_MOVE_DB
        ok &= abs(v["subtracted_speech_move_db"]) <= SPEECH_MOVE_DB
        ok &= v["pitch_frames"] > 0 and v["pitch_good"] >= PITCH_SHARE * v["pitch_frames"]
    res["ok"] = bool(ok)
    return res


# The ANI as the JAX composition reads it from the gate's audio (channel C
# from its opening, the first 5 rows: tests/test_torch_dispatch_monitor.py).
# The reference's rule merges equal digits when a 40 ms frame straddles a
# gap with the tone's tail in it; here the opening at 0.40125 s puts the
# tones 5 samples into their frames, so no frame straddles a gap and the
# three 5s stay apart.
EXPECTED_ANI = "5551234"


def dispatch_monitor_gate(device=DEFAULT_DEVICE) -> dict:
    """The scene (`dispatch_scene`) through the monitor on `device`.
    Returns ``ok`` (the bars), the bars, the stage times, the launches of
    each hand-written kernel, the seconds end to end (upload to the last
    stage; the numpy scene not counted), the chain's outputs and the
    capture rows (on `device`)."""
    device = resolve_device(device)
    host, truth = dispatch_scene(ROWS)
    before = launch_counts()
    _synchronize(device)
    t0 = time.perf_counter()
    capture = torch.from_numpy(host).to(device)
    out = dispatch_monitor_chain(capture)
    _synchronize(device)
    seconds = time.perf_counter() - t0
    launches = _launched(before)
    bars = dispatch_bars(out, truth)
    return {"ok": bars["ok"], "bars": bars, "stage_ms": out["stage_ms"], "launches": launches,
            "seconds": seconds, "outputs": out, "truth": truth, "capture": capture,
            "samples": ROWS * BLOCK, "device": str(device)}


def _pitch_passing(out: dict, truth: dict) -> list:
    channels = {ch.name: ch for ch in truth["channels"]}
    return [voice_levels(v, channels[v["name"]])["pitch_frames_passing"] for v in out["voice"]]


def dispatch_agreement(card: dict, cpu: dict, truth: dict) -> dict:
    """A card run of the chain against a CPU run of the same rows: squelch
    masks, tones, ANI strings, pages and the pitch frames that pass equal;
    the channels within IQ_TOL of their peak; the audio while both
    squelches are open within AUDIO_TOL of each channel's RMS (a noise-only
    discriminator sample near ±π may flip sign between two roundings, so
    closed stretches, which the monitor mutes, are not compared); the
    cleaned voice within VOICE_TOL."""
    res = {"open_equal": bool(torch.equal(card["open"].cpu(), cpu["open"])),
           "tones_equal": bool(torch.equal(card["tones"].cpu(), cpu["tones"])),
           "dial_equal": card["dial"] == cpu["dial"],
           "pages_equal": card["pages"] == cpu["pages"],
           "pitch_equal": _pitch_passing(card, truth) == _pitch_passing(cpu, truth)}
    res["channels_rel"] = compare(card["channels"], cpu["channels"])
    both = card["open"].cpu() & cpu["open"]
    mask = both[..., ::AUDIO_DECIMATION][..., : cpu["audio"].shape[-1]]
    worst = 0.0
    for i in range(cpu["audio"].shape[0]):
        m = mask[i]
        if not bool(m.any()):
            continue
        a, b = card["audio"][i].cpu()[m], cpu["audio"][i][m]
        worst = max(worst, float(torch.max(torch.abs(a - b)) / torch.sqrt(torch.mean(b * b))))
    res["audio_rel"] = worst
    res["voice_rel"] = max([compare([v["restored"], v["subtracted"]], [w["restored"],
                                                                        w["subtracted"]])
                            for v, w in zip(card["voice"], cpu["voice"])] or [0.0]) if len(
        card["voice"]) == len(cpu["voice"]) else math.inf
    res["ok"] = bool(all(res[k] for k in ("open_equal", "tones_equal", "dial_equal",
                                           "pages_equal", "pitch_equal"))
                     and res["channels_rel"] <= IQ_TOL and res["audio_rel"] <= AUDIO_TOL
                     and res["voice_rel"] <= VOICE_TOL)
    return res


# ------------------------------------------------------------ blocks gate

BLOCKS_TOL = 1e-5          # max|card − CPU| / max|CPU|: FFTs, sums and products in another order
BLOCKS_LOOP_TOL = 1e-4     # step loops (NLMS, all-pole synthesis, FastICA) and float32 solves
BLOCKS_PV_TOL = 1e-3       # the phase vocoder's phase sums at tens of thousands of radians


def _text(s) -> torch.Tensor:
    """A string result as its code points, so compare() holds it equal."""
    if isinstance(s, (bytes, bytearray)):
        return torch.tensor(list(s), dtype=torch.int64)
    return torch.tensor([ord(c) for c in str(s)], dtype=torch.int64)


def _frame(msg) -> list:
    return [_text(repr(sorted(dataclasses.asdict(msg).items())))] if msg is not None else []


def _ar2(rng, n=4096):
    e = rng.standard_normal(n)
    x = np.zeros(n)
    for i in range(2, n):
        x[i] = 1.3 * x[i - 1] - 0.6 * x[i - 2] + e[i]
    return x.astype(np.float32)


def _tags(tags) -> torch.Tensor:
    return _text(repr(tags))


def _blocks_cases(tmp: str):
    """(name, function, numpy inputs as (args, kwargs), tolerance): every
    BLOCKS entry of packets and audio (module.entry) and every public
    function of protocols, applied and adsb (module.function), on the
    inputs of their JAX tests (tests/test_protocols.py,
    test_scramblers_packets.py, test_adsb_ephemeris.py, test_audio.py,
    test_applied.py and the known-answer files). Byte framers and parsers
    are host code and give the same bytes on both runs; `tmp` is a
    directory for the file sinks."""
    tol, ltol = BLOCKS_TOL, BLOCKS_LOOP_TOL
    r = np.random.default_rng(51)
    fs = 8000.0
    t8k = np.arange(16000) / fs
    # tones in a little noise: no FFT bin near zero, whose log or ratio two
    # FFTs' roundings would move (the codec's bit allocation is a decision)
    tone440 = (np.sin(2 * np.pi * 440 * t8k[:8192]) + 0.05 * r.standard_normal(8192)).astype(
        np.float32)
    voiced = (sum(np.sin(2 * np.pi * 147.0 * k * t8k[:4096]) / k for k in range(1, 6))
              + 0.05 * r.standard_normal(4096)).astype(np.float32)
    speechy = (np.sin(2 * np.pi * 120 * t8k[:8000]) + 0.5 * np.sin(2 * np.pi * 240 * t8k[:8000])
               + 0.05 * r.standard_normal(8000)).astype(np.float32)
    clean = np.sin(2 * np.pi * 500 * t8k)
    clean[:2048] = 0.0
    noisy = (clean + 0.3 * r.standard_normal(t8k.size)).astype(np.float32)
    far = r.standard_normal(4000).astype(np.float32)
    echo = (0.8 * far + 0.4 * np.roll(far, 5) + 0.2 * np.roll(far, 11)).astype(np.float32)
    howl = np.sin(2 * np.pi * 2000 * t8k[:4000]).astype(np.float32)
    ar = _ar2(r)
    ctcss = (0.15 * np.sin(2 * np.pi * 123.0 * np.arange(4000) / fs)
             + 0.05 * r.standard_normal(4000)).astype(np.float32)
    apt_t = np.arange(int(11025.0 * 2)) / 11025.0
    apt = ((0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 4 * apt_t))) * np.sin(
        2 * np.pi * 2400 * apt_t)).astype(np.float32)
    burst = 0.01 * (r.standard_normal(8192) + 1j * r.standard_normal(8192))
    burst[2048:2560] += 1.0
    burst = burst.astype(np.complex64)
    vib_t = np.arange(40000) / 1e4
    vib = ((1.0 + 0.8 * (np.cos(2 * np.pi * 87 * vib_t) > 0.95)) * np.sin(2 * np.pi * 3200 * vib_t)
           + 0.3 * r.standard_normal(vib_t.size)).astype(np.float32)
    sub = np.concatenate([0.5 * r.standard_normal(2048), np.sin(2 * np.pi * 0.03 * np.arange(
        2048, 16384)) + 0.5 * r.standard_normal(14336)]).astype(np.float32)
    anchors = np.float32([[0, 0], [100, 0], [0, 100], [100, 100]])
    ranges = np.linalg.norm(anchors - [37.0, 64.0], axis=1).astype(np.float32)
    s_true = np.stack([np.sign(r.standard_normal(20000)), r.uniform(-1.7, 1.7, 20000)])
    mix = (np.asarray([[0.8, 0.6], [0.3, -0.9]]) @ s_true).astype(np.float32)
    a_cs = r.standard_normal((64, 256))
    a_cs /= np.linalg.norm(a_cs, axis=0)
    x_cs = np.zeros(256)
    x_cs[[12, 97, 200]] = [2.0, -1.5, 3.0]
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * r.integers(0, 4, 8192)))
    qpsk = (qpsk + 0.1 * (r.standard_normal(8192) + 1j * r.standard_normal(8192))).astype(
        np.complex64)
    pages = np.stack([pk.pocsag_encode_numeric(1234568, "0425 1234", 2),
                      pk.pocsag_encode_numeric(2000001, "5550100", 1)]).astype(np.int64)
    msg = adsb.AdsbMessage(icao=0x3C6DD0, type_code=4, callsign="DLH9U")
    ident = adsb.encode_identification(0x4840D6, "KLM1023")
    frame = pr.Ax25Frame(dest="APRS", source="N0CALL", info=b">hello from r4w", source_ssid=7)
    seven = ((np.arange(12, dtype=np.float32),), {})
    none = ((), {})
    stuffed = pr.hdlc_bit_stuff(np.int32([1, 1, 1, 1, 1, 1, 0, 1]))
    ais = pr.ais_encode_position(244_070_156, 52.37, 4.90, 12.3, 87.0)
    acars = pr.acars_encode("N12345", "Q0", "ETA 1430Z RWY 27L")
    return [
        # packets (tests/test_scramblers_packets.py::TestPackets, known-answer files)
        ("packets.packet_encoder", lambda: _text(pk.packet_encode(b"payload!")), none, 0),
        ("packets.packet_decoder", lambda: _text(pk.packet_decode(
            b"\x00\x01" + pk.packet_encode(b"payload!"))[0]), none, 0),
        ("packets.packet_sink", lambda: _text(repr(_sink())), none, 0),
        ("packets.header_payload_demux", lambda: [_text(v) for v in pk.header_payload_demux(
            b"HHHHpayload", 4)], none, 0),
        ("packets.protocol_formatter", lambda: [_text(pk.protocol_format(
            {"freq": "100", "mode": "fm"}, f)) for f in ("kv", "json")], none, 0),
        ("packets.protocol_frame_parser", lambda: _text(repr(pk.protocol_parse(
            b"freq=100;mode=fm"))), none, 0),
        ("packets.telemetry_framer", lambda: [_text(pk.telemetry_frame(
            [1.23, -4.56, 78.9], 7)), torch.from_numpy(pk.telemetry_parse(pk.telemetry_frame(
                [1.23, -4.56, 78.9], 7))[1])], none, 0),
        ("packets.random_pdu_gen", lambda: _text(pk.random_pdu((0, 0), 8, 16)), none, 0),
        ("packets.ccsds_frame", lambda: [_text(pk.ccsds_frame_encode(b"\xde\xad\xbe\xef",
                                                                     0x155, 3))], none, 0),
        ("packets.dvb_s2_deframer", lambda: _text(repr(pk.dvb_s2_deframe(
            pk.dvb_s2_bbheader(4, 16000) + b"\x00" * 10))), none, 0),
        ("packets.zigbee_frame_parser", lambda: _text(repr(pk.zigbee_frame_parse(
            pk.zigbee_frame_build(b"sensor", 42, 0xBEEF, 0x0010)))), none, 0),
        ("packets.pocsag_decoder", pk.pocsag_decode, ((pages,), {}), 0),
        ("packets.psk31_codec", lambda: [torch.from_numpy(pk.psk31_encode("cq cq de r4w")),
                                         _text(pk.psk31_decode(pk.psk31_encode("cq cq de r4w")))],
         none, 0),
        ("packets.noaa_weather_decoder", lambda a: pk.noaa_apt_lines(a, 11025.0), ((apt,), {}),
         0),
        ("packets.meteor_burst_decoder", lambda x: pk.meteor_burst_detect(x, 256), ((burst,), {}),
         tol),
        ("packets.sigfox_decoder", lambda: _text(repr(pk.sigfox_frame_parse(
            b"\xaa" + pk.sigfox_frame_build(0xCAFEBABE, 5, b"\x01\x02\x03")))), none, 0),
        ("packets.tagged_stream_align", lambda x: pk.tagged_stream_align(
            x, [(2, {"other": 1}), (4, {"len": 8})])[0], seven, 0),
        ("packets.tagged_stream_mux", lambda x: list(pk.tagged_stream_mux([x[:3], x[3:5]])),
         seven, 0),
        ("packets.tagged_stream_multiply_length", lambda: _tags(
            pk.tagged_stream_multiply_length([(0, {"len": 3}), (3, {"len": 2})], 2)), none, 0),
        ("packets.tag_share", lambda: _tags(pk.tag_share([(0, {"len": 3})], [(1, {"x": 1})])),
         none, 0),
        ("packets.tag_debug", lambda: _text(pk.tag_debug([(0, {"len": 3})])), none, 0),
        ("packets.stream_to_tagged_stream", lambda x: [pk.stream_to_tagged(x, 4)[0], _tags(
            pk.stream_to_tagged(x, 4)[1])], seven, 0),
        ("packets.tagged_file_sink", lambda x: torch.from_numpy(np.fromfile(pk.tagged_file_sink(
            f"{tmp}/tagged.bin", x, [(0, {"len": 12})]), np.float32)), seven, 0),
        ("packets.file_meta", lambda x: torch.from_numpy(pk.file_meta_read(pk.file_meta_write(
            f"{tmp}/meta.bin", x, {"fs": 1000}))[0]), seven, 0),
        # audio (tests/test_audio.py, known-answer files)
        ("audio.dtmf", lambda device: au.dtmf_generate("1234567890*#ABCD", device=device),
         ((), {"device": DEVICE}), 0),
        ("audio.dtmf_detector", lambda a: _text(au.dtmf_detect(a)),
         ((au.dtmf_generate("5551234", device="cpu").numpy(),), {}), 0),
        ("audio.mfcc_extractor", lambda a: au.mfcc(a, 16000.0), ((tone440,), {}), tol),
        ("audio.phase_vocoder", lambda a: au.phase_vocoder(a, 0.5), ((tone440,), {}),
         BLOCKS_PV_TOL),
        ("audio.melp_vocoder", lambda a: _melp(a, fs), ((speechy,), {}), ltol),
        ("audio.speech_formant_tracker", lambda a: au.formant_track(a, fs), ((ar,), {}), ltol),
        ("audio.psychoacoustic_codec", lambda a: (au.psychoacoustic_encode(a, 16000.0),
                                                  au.psychoacoustic_decode(
                                                      *au.psychoacoustic_encode(a, 16000.0))),
         ((tone440,), {}), tol),
        ("audio.speech_voice_restoration", lambda a: au.voice_restore(a, fs), ((noisy,), {}),
         tol),
        ("audio.music_pitch_detector", lambda a: au.pitch_detect(a, fs), ((tone440,), {}), tol),
        ("audio.music_pitch_tracker", lambda a: au.pitch_track(a, fs), ((tone440,), {}), tol),
        ("audio.acoustic_echo_canceller", lambda m, f: au.echo_cancel_nlms(m, f, 16),
         ((echo, far), {}), ltol),
        ("audio.hearing_aid_feedback_suppressor", lambda a: au.feedback_suppress(a, 64),
         ((howl,), {}), ltol),
        ("audio.vocoder", lambda m, c: au.channel_vocoder(m, c, fs), ((speechy, far), {}), tol),
        # protocols (tests/test_protocols.py, known-answer files)
        ("protocols.crc16_x25", lambda: torch.tensor(pr.crc16_x25(b"123456789")), none, 0),
        ("protocols.hdlc_bit_stuff", lambda: torch.from_numpy(stuffed), none, 0),
        ("protocols.hdlc_bit_unstuff", lambda: torch.from_numpy(pr.hdlc_bit_unstuff(stuffed)),
         none, 0),
        ("protocols.nrzi_encode", lambda: torch.from_numpy(pr.nrzi_encode(
            np.int32([0, 1, 1, 0, 0, 0, 1]))), none, 0),
        ("protocols.nrzi_decode", lambda: torch.from_numpy(pr.nrzi_decode(pr.nrzi_encode(
            np.int32([0, 1, 1, 0, 0, 0, 1])))), none, 0),
        ("protocols.ax25_encode", lambda: torch.from_numpy(pr.ax25_encode(frame)), none, 0),
        ("protocols.ax25_decode", lambda: _text(repr(pr.ax25_decode(pr.ax25_encode(frame)))),
         none, 0),
        ("protocols.aprs_encode", lambda: torch.from_numpy(pr.aprs_encode(
            "K1ABC", "!4903.50N/07201.75W-Test")), none, 0),
        ("protocols.aprs_decode", lambda: _text(repr(pr.aprs_decode(pr.aprs_encode(
            "K1ABC", "!4903.50N/07201.75W-Test")))), none, 0),
        ("protocols.slip_encode", lambda: _text(pr.slip_encode(bytes([1, 0xC0, 2, 0xDB, 3]))),
         none, 0),
        ("protocols.slip_decode", lambda: _text(repr(pr.slip_decode(
            pr.slip_encode(b"one") + pr.slip_encode(b"two")))), none, 0),
        ("protocols.nmea_checksum", lambda: torch.tensor(pr.nmea_checksum("AIVDM,1,1,,A,x,0")),
         none, 0),
        ("protocols.ais_encode_position", lambda: _text(ais), none, 0),
        ("protocols.ais_decode", lambda: _text(repr(pr.ais_decode(ais))), none, 0),
        ("protocols.acars_encode", lambda: _text(acars), none, 0),
        ("protocols.acars_decode", lambda: _text(repr(pr.acars_decode(acars))), none, 0),
        ("protocols.ctcss_detect", lambda a: pr.ctcss_detect(a, fs), ((ctcss,), {}), tol),
        ("protocols.ctcss_generate", lambda device: pr.ctcss_generate(123.0, 4000, fs,
                                                                      device=device),
         ((), {"device": DEVICE}), tol),
        # applied (tests/test_applied.py, known-answer files)
        ("applied.nanmedian", lambda v: ap.nanmedian(v), ((np.float32(
            [[1, np.nan, 3, 8], [5, 2, np.nan, np.nan]]),), {}), 0),
        ("applied.spectral_subtraction", ap.spectral_subtraction, ((sub,), {}), tol),
        ("applied.wavelet_denoise", ap.wavelet_denoise, ((sub[:4096],), {}), tol),
        ("applied.real_cepstrum", ap.real_cepstrum, ((voiced,), {}), tol),
        ("applied.cepstral_pitch", lambda x: ap.cepstral_pitch(x, fs), ((voiced,), {}), tol),
        ("applied.lpc_coefficients", lambda x: ap.lpc_coefficients(x, 2), ((ar,), {}), ltol),
        ("applied.lpc_analysis_synthesis", ap.lpc_analysis_synthesis, ((voiced[:2400],), {}),
         ltol),
        ("applied.envelope_spectrum", lambda x: ap.envelope_spectrum(x, 1e4), ((vib,), {}), tol),
        ("applied.bearing_fault_metric", lambda x: ap.bearing_fault_metric(x, 1e4, 87.0),
         ((vib,), {}), tol),
        ("applied.trilaterate", ap.trilaterate, ((anchors, ranges), {}), ltol),
        ("applied.fastica_2x2", ap.fastica_2x2, ((mix,), {}), ltol),
        ("applied.omp", lambda a, y: ap.omp(a, y, 3), ((a_cs, a_cs @ x_cs), {}), ltol),
        ("applied.modulation_features", lambda x: torch.tensor(list(
            ap.modulation_features(x).values())), ((qpsk,), {}), tol),
        ("applied.classify_modulation", lambda x: _text(ap.classify_modulation(x)),
         ((qpsk,), {}), 0),
        # adsb (tests/test_adsb_ephemeris.py, known-answer files)
        ("adsb.crc24", lambda: torch.tensor(adsb.crc24(ident)), none, 0),
        ("adsb.encode_identification", lambda: torch.from_numpy(ident), none, 0),
        ("adsb.encode_altitude", lambda: torch.from_numpy(adsb.encode_altitude(0xABCDEF, 38000)),
         none, 0),
        ("adsb.decode_frame_bytes", lambda: _frame(adsb.decode_frame_bytes(
            np.packbits(ident.astype(np.uint8)).tobytes())), none, 0),
        ("adsb.transmit_over_ppm", lambda device: adsb.transmit_over_ppm(msg, 8e6, device),
         ((), {"device": DEVICE}), 0),
        ("adsb.receive_over_ppm", lambda x: _frame(adsb.receive_over_ppm(x, 8e6)),
         ((adsb.transmit_over_ppm(msg, 8e6, "cpu").numpy(),), {}), 0),
    ]


DEVICE = object()   # in a case's kwargs: the device the gate runs the case on


def _sink():
    sink = pk.PacketSink()
    f = pk.packet_encode(b"payload!")
    bad = bytearray(f)
    bad[-3] ^= 0xFF
    sink.push(f)
    sink.push(bytes(bad))
    return sink


def _melp(a, fs):
    params = au.melp_analyze(a, fs)
    return [params[k] for k in ("lpc", "gain", "pitch", "voiced")] + [au.melp_synthesize(params)]


def _public(module) -> list[str]:
    return [n for n, v in vars(module).items() if not n.startswith("_") and inspect.isfunction(v)
            and v.__module__ == module.__name__]


def blocks_names() -> list[str]:
    """Every `BLOCKS` entry of packets and audio as module.entry, and every
    public function of protocols, applied and adsb as module.function."""
    return ([f"{m.__name__.rsplit('.', 1)[-1]}.{k}" for m in (pk, au) for k in m.BLOCKS]
            + [f"{m.__name__.rsplit('.', 1)[-1]}.{n}" for m in (pr, ap, adsb)
               for n in _public(m)])


def protocol_blocks_gate(device=DEFAULT_DEVICE) -> dict:
    """Every case of `_blocks_cases` on `device` and on the CPU (the worst
    difference a case, inf for differing decisions; each held to its
    tolerance). Returns ``ok``, ``worst`` by case, ``failed``, ``missing``,
    the worst case by name, and the launches of each hand-written kernel."""
    device = resolve_device(device)
    cpu = torch.device("cpu")
    worst, failed = {}, []
    before = launch_counts()
    with tempfile.TemporaryDirectory() as tmpdir:
        for name, fn, (args, kwargs), tol in _blocks_cases(tmpdir):
            got, want = (fn(*_on(list(args), d), **{k: d if v is DEVICE else v
                                                     for k, v in kwargs.items()})
                         for d in (device, cpu))
            worst[name] = compare(got, want)
            if not worst[name] <= tol:
                failed.append(name)
    missing = sorted(set(blocks_names()) - set(worst))
    top = max(worst, key=lambda k: worst[k])
    return {"ok": not failed and not missing, "worst": worst, "failed": failed,
            "missing": missing, "worst_case": (top, worst[top]), "launches": _launched(before),
            "device": str(device)}
