"""Audio & speech processing fills.

PyTorch counterpart of ``r4w_tpu.ops.audio`` (dtmf.rs / dtmf_detector.rs,
mfcc_extractor.rs, phase_vocoder.rs, melp_vocoder.rs,
psychoacoustic_codec.rs, speech_formant_tracker.rs,
speech_voice_restoration.rs, music_pitch_detector.rs /
music_pitch_tracker.rs, acoustic_echo_canceller.rs,
hearing_aid_feedback_suppressor.rs, vocoder.rs).

Frame-based analysis is one batched FFT over all frames, on the samples'
device. Overlap-adds sum each output sample's frames in frame order from
zero, as the reference's scatter-add does (`overlap_add`: one slice-add a
frame offset, never an ``index_add_``). The Levinson-Durbin recursion
(`levinson`) is a loop over the order batched over frames, its inner
products summed term by term in order, so the card's coefficients are the
CPU's. MELP's order-10 all-pole synthesis and the NLMS cancellers are step
loops over the samples (no device value read on the host inside them).
DTMF forms its Goertzel energies on the device and decides on the host,
as the reference does; the formant tracker's polynomial roots are host
numpy. Divisions by a Python number go through a float32 tensor
(`real_scalar`), so the card rounds as the CPU does.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs
from r4w_tpu_torch.core.types import REAL_DTYPE, real_scalar, resolve_device, to_tensor
from r4w_tpu_torch.ops.filters import _cumsum
from r4w_tpu_torch.ops.spectral2 import _gather_frames, _hanning, _real

_DTMF_LOW = (697.0, 770.0, 852.0, 941.0)
_DTMF_HIGH = (1209.0, 1336.0, 1477.0, 1633.0)
_DTMF_KEYS = "123A456B789C*0#D"


def _window(w: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(w, np.float32)).to(device)


def overlap_add(frames: torch.Tensor, hop: int, out_len: int) -> torch.Tensor:
    """(..., F, L) frames placed at f·hop and summed into (..., out_len),
    each output sample's frames added in frame order from zero: the
    reference's ``zeros.at[idx].add(frames)``, whose scatter adds its
    updates in order. When hop divides L, frame offset b of every frame
    lands on output block f + b, so the offsets are added from the last to
    the first (a frame's later offset meets an output block before the
    next frame's earlier one), one slice-add an offset; else one slice-add
    a frame."""
    lead, n_frames, length = frames.shape[:-2], frames.shape[-2], frames.shape[-1]
    span = (n_frames - 1) * hop + length
    out = frames.new_zeros(lead + (max(out_len, span),))
    if length % hop == 0:
        r = length // hop
        blocks = out[..., : (n_frames + r - 1) * hop].view(*lead, n_frames + r - 1, hop)
        parts = frames.reshape(*lead, n_frames, r, hop)
        for b in reversed(range(r)):
            blocks[..., b:b + n_frames, :] += parts[..., b, :]
    else:
        for f in range(n_frames):
            out[..., f * hop:f * hop + length] += frames[..., f, :]
    return out[..., :out_len]


def _ordered_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ a[..., j]·b[..., j] over the last axis, term by term in order."""
    acc = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j] * b[..., j]
    return acc


def levinson(r: torch.Tensor, order: int):
    """Levinson-Durbin on autocorrelations r (..., ≥ order+1) float32:
    (prediction filter (..., order+1) with a[0] = 1, residual gain (...,)),
    the reference's static-order recursion over every leading row."""
    lead = r.shape[:-1]
    a = r.new_zeros(lead + (order + 1,))
    a[..., 0] = 1.0
    e = torch.clamp(r[..., 0], min=1e-12)
    for m in range(1, order + 1):
        k = -_ordered_dot(a[..., :m], r[..., 1:m + 1].flip(-1)) / e
        # Levinson recursion incl. a_new[m] = k (a[0]·k term)
        a = torch.cat([a[..., : m + 1] + k[..., None] * a[..., : m + 1].flip(-1),
                       a[..., m + 1:]], dim=-1)
        e = e * (1.0 - k * k)
    return a, torch.sqrt(torch.clamp(e, min=1e-12))


def _autocorrelation(f: torch.Tensor, lags: int) -> torch.Tensor:
    """Lags 0..lags-1 of each row's autocorrelation by a zero-padded FFT."""
    n = f.shape[-1]
    sp = torch.fft.rfft(f, 2 * n, dim=-1)
    return torch.fft.irfft(sp * torch.conj(sp), 2 * n, dim=-1)[..., :lags]


# ---------------------------------------------------------------- DTMF


def dtmf_generate(digits: str, sample_rate: float = 8000.0,
                  tone_ms: float = 80.0, gap_ms: float = 40.0, device=None):
    """DTMF dial string → audio (dtmf.rs), made in numpy as the reference
    makes it and put on `device`."""
    n_tone = int(sample_rate * tone_ms / 1000.0)
    n_gap = int(sample_rate * gap_ms / 1000.0)
    t = np.arange(n_tone) / sample_rate
    out = []
    for d in digits:
        k = _DTMF_KEYS.index(d)
        f_lo = _DTMF_LOW[k // 4]
        f_hi = _DTMF_HIGH[k % 4]
        tone = 0.5 * (np.sin(2 * np.pi * f_lo * t)
                      + np.sin(2 * np.pi * f_hi * t))
        out.append(tone)
        out.append(np.zeros(n_gap))
    return to_tensor(np.concatenate(out).astype(np.float32), device=resolve_device(device))


def dtmf_energies(audio, sample_rate: float = 8000.0, frame_ms: float = 40.0):
    """The detector's device half: (E (F, 8) Goertzel energies of the
    40 ms frames at the 8 DTMF tones, low group first; the frames' energy
    scale (F,) = mean(x²)·n²/4)."""
    a = _real(audio)
    n_frame = int(sample_rate * frame_ms / 1000.0)
    n = (a.shape[0] // n_frame) * n_frame
    frames = a[:n].reshape(-1, n_frame)
    t = torch.arange(n_frame, dtype=REAL_DTYPE, device=a.device) / real_scalar(
        sample_rate, a.device)
    freqs = torch.tensor(_DTMF_LOW + _DTMF_HIGH, dtype=REAL_DTYPE, device=a.device)
    ph = 2 * np.pi * freqs[:, None] * t[None, :]
    e = (frames @ torch.cos(ph).T) ** 2 + (frames @ torch.sin(ph).T) ** 2  # (F, 8)
    total = torch.mean(frames ** 2, dim=-1) * n_frame ** 2 / real_scalar(4.0, a.device)
    return e, total


def dtmf_detect(audio, sample_rate: float = 8000.0,
                frame_ms: float = 40.0, threshold: float = 8.0) -> str:
    """DTMF detection via a Goertzel bank over frames
    (dtmf_detector.rs). Returns the dialed string.

    The energies come from the device (`dtmf_energies`), the decisions
    from the host, as in the reference, with its rule for repeats: a key
    is written when it differs from the last frame's key, and only a
    silent frame (energy under 1e-6) or one that fails the two-tone test
    resets it. A 40 ms frame that straddles a 40 ms gap still holds the
    tone's tail and passes, so equal digits dialled at 80/40 ms merge:
    "5551234" reads "51234"."""
    e, total = dtmf_energies(audio, sample_rate, frame_ms)
    e = e.cpu().numpy()
    total = total.cpu().numpy()
    digits = []
    last = None
    for f in range(e.shape[0]):
        if total[f] < 1e-6:
            last = None
            continue
        lo = int(np.argmax(e[f, :4]))
        hi = int(np.argmax(e[f, 4:]))
        # both tones must dominate the frame energy
        if (e[f, lo] + e[f, 4 + hi]) > threshold * 0.1 * total[f]:
            key = _DTMF_KEYS[lo * 4 + hi]
            if key != last:
                digits.append(key)
            last = key
        else:
            last = None
    return "".join(digits)


# ---------------------------------------------------------------- MFCC


def _mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _imel(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mfcc(audio, sample_rate: float, n_mfcc: int = 13, n_mels: int = 26,
         n_fft: int = 512, hop: int = 256):
    """Mel-frequency cepstral coefficients (mfcc_extractor.rs):
    frame → |FFT|² → mel filterbank → log → DCT-II. One batched FFT."""
    a = _real(audio)
    frames = _gather_frames(a, n_fft, hop) * _hanning(n_fft, a.device)
    power = complex_abs(torch.fft.rfft(frames, dim=-1)) ** 2
    # mel filterbank (host-side constants)
    mel_pts = np.linspace(_mel(0.0), _mel(sample_rate / 2), n_mels + 2)
    hz_pts = _imel(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(1, n_mels + 1):
        l, c, r = bins[m - 1], bins[m], bins[m + 1]
        for k in range(l, c):
            fb[m - 1, k] = (k - l) / max(c - l, 1)
        for k in range(c, r):
            fb[m - 1, k] = (r - k) / max(r - c, 1)
    mel_e = power @ _window(fb, a.device).T
    log_e = torch.log(torch.clamp(mel_e, min=1e-10))
    # DCT-II matrix
    k = np.arange(n_mfcc)[:, None]
    nvec = np.arange(n_mels)[None, :]
    dct = np.cos(np.pi * k * (2 * nvec + 1) / (2 * n_mels)) \
        * np.sqrt(2.0 / n_mels)
    return log_e @ _window(dct, a.device).T


# -------------------------------------------------------- phase vocoder


def phase_vocoder(audio, rate: float, n_fft: int = 1024,
                  hop: int = 256):
    """Time-stretch by ``rate`` without pitch change (phase_vocoder.rs):
    STFT, per-bin phase advance re-accumulated at the new hop. The
    positions are floors of float32 products, the phase wrap rounds half
    to even, the accumulation is a cumulative sum (float64, rounded once)
    and the overlap-add follows frame order."""
    a = _real(audio)
    dev = a.device
    win = _hanning(n_fft, dev)
    n_frames = max(2, (a.shape[0] - n_fft) // hop + 1)
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop
           + torch.arange(n_fft, device=dev)[None, :]).clamp(max=a.shape[0] - 1)
    stft = torch.fft.rfft(a[idx] * win, dim=-1)          # (F, K)
    # analysis positions for synthesis frames
    out_frames = int(n_frames / rate)
    pos = torch.arange(out_frames, dtype=REAL_DTYPE, device=dev) * rate
    i0 = torch.floor(pos).to(torch.int32)
    frac = pos - i0
    i0 = torch.clamp(i0, 0, n_frames - 2).long()
    mag = (1 - frac)[:, None] * complex_abs(stft[i0]) \
        + frac[:, None] * complex_abs(stft[i0 + 1])
    # phase advance between consecutive analysis frames
    omega = 2 * np.pi * torch.arange(n_fft // 2 + 1, dtype=REAL_DTYPE,
                                     device=dev) * hop / real_scalar(n_fft, dev)
    two_pi = real_scalar(2 * np.pi, dev)
    dphi = torch.angle(stft[i0 + 1]) - torch.angle(stft[i0]) - omega[None, :]
    dphi = dphi - two_pi * torch.round(dphi / two_pi)
    inst = omega[None, :] + dphi
    phase = _cumsum(inst.T).T
    spec = mag * cis(phase)
    frames_out = torch.fft.irfft(spec, n_fft, dim=-1) * win[None, :]
    out = overlap_add(frames_out, hop, out_frames * hop + n_fft)
    return out / real_scalar(n_fft / (2.0 * hop), dev)


# ------------------------------------------------------------- vocoders


def lpc_coeffs_frame(frames, order: int):
    """Batched LPC via autocorrelation + Levinson-Durbin
    (melp_vocoder.rs analysis). frames: (F, N) → (F, order+1) coeffs
    and (F,) gains."""
    f = _real(frames)
    # all lags for all frames in one FFT autocorrelation
    acf = _autocorrelation(f, order + 1)
    coeffs, gains = levinson(acf, order)
    # degenerate (silent) frames: identity filter, zero-ish gain
    ok = acf[:, 0] > 0
    ident = torch.zeros_like(coeffs)
    ident[:, 0] = 1.0
    coeffs = torch.where(ok[:, None], coeffs, ident)
    gains = torch.where(ok, gains, torch.zeros_like(gains))
    return coeffs, gains


def melp_analyze(audio, sample_rate: float = 8000.0, frame: int = 180,
                 order: int = 10):
    """MELP-style analysis (melp_vocoder.rs): per-frame LPC + pitch +
    voicing + gain. Returns a dict of parameter tracks."""
    a = _real(audio)
    n_frames = a.shape[0] // frame
    frames = a[:n_frames * frame].reshape(n_frames, frame)
    coeffs, gains = lpc_coeffs_frame(frames, order)
    # batched pitch: one FFT autocorrelation over all frames, argmax
    # in the 60-400 Hz lag band
    fj = frames - torch.mean(frames, dim=-1, keepdim=True)
    ac = _autocorrelation(fj, frame)
    lo, hi = int(sample_rate / 400), int(sample_rate / 60)
    if hi < frame:
        k = lo + torch.argmax(ac[:, lo:hi], dim=-1)
        ratio = torch.gather(ac, -1, k[:, None])[:, 0] \
            / torch.clamp(ac[:, 0], min=1e-9)
        voiced = (ratio > 0.35) & (ac[:, 0] > 1e-9)
        pitch = torch.where(voiced, real_scalar(sample_rate, a.device) / k.to(REAL_DTYPE),
                            torch.zeros_like(ratio))
    else:
        voiced = torch.zeros(n_frames, dtype=torch.bool, device=a.device)
        pitch = torch.zeros(n_frames, dtype=REAL_DTYPE, device=a.device)
    return {"lpc": coeffs, "gain": gains, "pitch": pitch,
            "voiced": voiced, "frame": frame,
            "sample_rate": sample_rate}


def all_pole(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[t] = x[t] − Σ_k a[..., k]·y[t−k] along x's last axis from zero
    state, each row with its own filter a (..., order+1), a[..., 0] = 1:
    the reference's scan, a step loop over the samples batched over the
    rows, the feedback summed term by term in order."""
    order = a.shape[-1] - 1
    fb = a[..., 1:]
    state = x.new_zeros(x.shape[:-1] + (order,))
    ys = []
    for t in range(x.shape[-1]):
        y_t = x[..., t] - _ordered_dot(fb, state) if order else x[..., t]
        state = torch.cat([y_t[..., None], state[..., :-1]], dim=-1)
        ys.append(y_t)
    return torch.stack(ys, dim=-1) if ys else x.clone()


def melp_synthesize(params, seed: int = 0):
    """MELP-style synthesis: pulse train (voiced) / noise (unvoiced)
    excitation through the LPC all-pole filter. The noise bank is the
    reference's host draw, ``np.random.default_rng(seed)``."""
    frame = params["frame"]
    fs = params["sample_rate"]
    lpc = _real(params["lpc"])                        # (F, order+1)
    dev = lpc.device
    gain = to_tensor(params["gain"], REAL_DTYPE, dev)
    pitch = to_tensor(params["pitch"], REAL_DTYPE, dev)
    voiced = to_tensor(params["voiced"], torch.bool, dev)
    n_frames = lpc.shape[0]
    # static noise bank (seeded host RNG — design-time randomness)
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.standard_normal(
        (n_frames, frame)).astype(np.float32)).to(dev)
    t = torch.arange(frame, device=dev)
    period = torch.clamp((real_scalar(fs, dev) / torch.clamp(pitch, min=1.0)).to(torch.int32),
                         1, frame)[:, None]
    pulse = torch.where(torch.remainder(t[None, :], period) == 0,
                        torch.sqrt(period.to(REAL_DTYPE)), torch.zeros((), device=dev))
    exc = torch.where((voiced & (pitch > 0))[:, None], pulse, noise) * gain[:, None]
    return all_pole(lpc, exc).reshape(-1)


def formant_track(audio, sample_rate: float, frame: int = 256,
                  order: int = 12, n_formants: int = 3):
    """Formant frequencies from LPC polynomial roots
    (speech_formant_tracker.rs). Returns (F, n_formants) Hz. The LPC runs
    on the audio's device (the default device for host input), the roots
    on the host."""
    device = audio.device if isinstance(audio, torch.Tensor) else resolve_device(None)
    a = np.asarray(audio.detach().cpu().numpy() if isinstance(audio, torch.Tensor) else audio,
                   np.float64)
    n_frames = a.shape[0] // frame
    frames = a[:n_frames * frame].reshape(n_frames, frame) \
        * np.hanning(frame)
    coeffs, _ = lpc_coeffs_frame(torch.from_numpy(frames.astype(np.float32)).to(device), order)
    coeffs = coeffs.cpu().numpy()
    out = np.zeros((n_frames, n_formants))
    for i in range(n_frames):
        roots = np.roots(coeffs[i])
        # keep narrow-bandwidth upper-half-plane poles only
        roots = roots[(np.imag(roots) > 0.01) & (np.abs(roots) > 0.88)]
        freqs = np.sort(np.angle(roots) * sample_rate / (2 * np.pi))
        freqs = freqs[(freqs > 90) & (freqs < sample_rate / 2 - 50)]
        out[i, :min(n_formants, freqs.shape[0])] = \
            freqs[:n_formants]
    return torch.from_numpy(out.astype(np.float32)).to(device)


# -------------------------------------------------------- psychoacoustic


def _sine_window(n_fft: int, device) -> torch.Tensor:
    return _window(np.sin(np.pi * (np.arange(n_fft) + 0.5) / n_fft), device)


def _convolve_same(v: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """``np.convolve(row, kernel, mode="same")`` of every row of v (..., n),
    the kernel's terms added in order."""
    taps = kernel.shape[0]
    n = v.shape[-1]
    pad = torch.nn.functional.pad(v, (taps - 1, taps - 1))
    start = (taps - 1) // 2 + taps - 1
    k = torch.from_numpy(kernel.astype(np.float32)).to(v.device)
    acc = k[0] * pad[..., start:start + n]
    for j in range(1, taps):
        acc = acc + k[j] * pad[..., start - j:start - j + n]
    return acc


def _scale(z: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Complex z over real s, part by part."""
    return torch.complex(z.real / s, z.imag / s)


def psychoacoustic_encode(audio, sample_rate: float, n_fft: int = 512,
                          bits_budget: int = 4):
    """Toy transform codec with masking-driven bit allocation
    (psychoacoustic_codec.rs): MDCT-like windowed FFT bands, a
    spreading-function masking threshold, and per-band quantization
    proportional to SMR. Returns (quantized, scale, bits) per frame."""
    a = _real(audio)
    hop = n_fft // 2
    spec = torch.fft.rfft(_gather_frames(a, n_fft, hop) * _sine_window(n_fft, a.device), dim=-1)
    power = complex_abs(spec) ** 2
    # masking threshold: power convolved with an asymmetric spread
    spread = np.concatenate([
        10.0 ** (-np.arange(8)[::-1] * 2.5 / 10),
        10.0 ** (-np.arange(1, 20) * 1.0 / 10)])
    thr = _convolve_same(power, spread) * 0.05
    smr = power / torch.clamp(thr, min=1e-12)
    bits = torch.clamp(torch.round(torch.log2(torch.clamp(smr, min=1.0)) / 2),
                       0, bits_budget).to(torch.int32)
    scale = torch.amax(complex_abs(spec), dim=-1, keepdim=True)
    steps = 2.0 ** bits.to(REAL_DTYPE)
    z = _scale(spec, torch.clamp(scale, min=1e-12))
    q = torch.complex(torch.round(z.real * steps), torch.round(z.imag * steps))
    return q, scale, bits


def psychoacoustic_decode(q, scale, bits, n_fft: int = 512):
    q = to_tensor(q)
    steps = 2.0 ** to_tensor(bits, REAL_DTYPE, q.device)
    z = _scale(q, torch.clamp(steps, min=1.0))
    spec = z * to_tensor(scale, REAL_DTYPE, q.device)
    hop = n_fft // 2
    frames = torch.fft.irfft(spec, n_fft, dim=-1) * _sine_window(n_fft, q.device)[None, :]
    n_frames = frames.shape[0]
    return overlap_add(frames, hop, n_frames * hop + n_fft)


# ----------------------------------------------------------- restoration


def voice_restore(audio, sample_rate: float, n_fft: int = 512,
                  noise_frames: int = 6, oversubtract: float = 2.0):
    """Spectral-subtraction voice restoration
    (speech_voice_restoration.rs): estimate the noise floor from the
    first frames, subtract with flooring, resynthesize via overlap-add
    (frame order). Leading axes are rows, each with its own floor."""
    a = _real(audio)
    hop = n_fft // 2
    n_frames = max(1, (a.shape[-1] - n_fft) // hop + 1)
    win = _hanning(n_fft, a.device)
    spec = torch.fft.rfft(_gather_frames(a, n_fft, hop) * win, dim=-1)
    mag = complex_abs(spec)
    noise = torch.mean(mag[..., :noise_frames, :], dim=-2, keepdim=True)
    clean = torch.maximum(mag - oversubtract * noise, 0.05 * mag)
    out_spec = clean * cis(torch.angle(spec))
    frames = torch.fft.irfft(out_spec, n_fft, dim=-1) * win
    out = overlap_add(frames, hop, n_frames * hop + n_fft)
    # hann^2 COLA constant at 50% overlap = 0.75
    return out / real_scalar(0.75, a.device)


# ------------------------------------------------------------- pitch


def pitch_detect(audio, sample_rate: float, f_lo: float = 60.0,
                 f_hi: float = 1000.0):
    """Autocorrelation pitch of one block (music_pitch_detector.rs); leading
    axes are blocks. The first maximum of the lag band, as the reference."""
    a = _real(audio)
    a = a - torch.mean(a, dim=-1, keepdim=True)
    n = a.shape[-1]
    nfft = 1 << (2 * n - 1).bit_length()
    ps = complex_abs(torch.fft.rfft(a, nfft, dim=-1)) ** 2
    ac = torch.fft.irfft(ps, dim=-1)[..., :n]
    lo = int(sample_rate / f_hi)
    hi = min(int(sample_rate / f_lo), n - 1)
    k = lo + torch.argmax(ac[..., lo:hi], dim=-1)
    strength = torch.gather(ac, -1, k[..., None])[..., 0] / torch.clamp(ac[..., 0], min=1e-12)
    return real_scalar(sample_rate, a.device) / k.to(REAL_DTYPE), strength


def pitch_track(audio, sample_rate: float, frame: int = 1024,
                hop: int = 512):
    """Frame-by-frame pitch contour (music_pitch_tracker.rs): every frame
    in one batched `pitch_detect`."""
    return pitch_detect(_gather_frames(_real(audio), frame, hop), sample_rate)


# --------------------------------------------------------- echo control


def echo_cancel_nlms(mic, ref, n_taps: int = 64, mu: float = 0.5):
    """Acoustic echo canceller (acoustic_echo_canceller.rs): NLMS
    adaptive FIR from the reference (far-end) to the mic signal, a step
    loop over the samples. Returns (error=echo-free, final_weights)."""
    d = _real(mic)
    x = to_tensor(ref, REAL_DTYPE, d.device)
    xpad = torch.cat([x.new_zeros(n_taps - 1), x])
    idx = (torch.arange(d.shape[0], device=d.device)[:, None]
           + torch.arange(n_taps, device=d.device)[None, :])
    xmat = xpad[idx].flip(-1)                      # (N, taps) newest first
    norms = torch.sum(xmat * xmat, dim=-1) + 1e-6
    mu_t = real_scalar(mu, d.device)
    w = x.new_zeros(n_taps)
    err = []
    for n in range(d.shape[0]):
        xv = xmat[n]
        e = d[n] - torch.dot(w, xv)
        w = w + mu_t * e * xv / norms[n]
        err.append(e)
    return (torch.stack(err) if err else d.new_zeros(0)), w


def feedback_suppress(audio, delay: int = 128, n_taps: int = 32,
                      mu: float = 0.2):
    """Hearing-aid feedback suppressor
    (hearing_aid_feedback_suppressor.rs): NLMS prediction from the
    DELAYED output path; the periodic feedback component is predicted
    and subtracted while speech (less predictable at that lag)
    passes."""
    a = _real(audio)
    ref = torch.cat([a.new_zeros(delay), a])[:a.shape[0]]
    err, _ = echo_cancel_nlms(a, ref, n_taps, mu)
    return err


def channel_vocoder(modulator, carrier, sample_rate: float,
                    n_bands: int = 12):
    """Classic channel vocoder (vocoder.rs): the modulator's per-band
    envelopes drive the carrier's bands. Bands via one batched FFT
    mask."""
    m = _real(modulator)
    c = to_tensor(carrier, REAL_DTYPE, m.device)
    n = min(m.shape[0], c.shape[0])
    m, c = m[:n], c[:n]
    mf = torch.fft.rfft(m)
    cf = torch.fft.rfft(c)
    k = mf.shape[0]
    edges = np.unique(np.geomspace(4, k - 1, n_bands + 1).astype(int))
    out = m.new_zeros(n)
    for i in range(len(edges) - 1):
        mask = m.new_zeros(k)
        mask[edges[i]:edges[i + 1]] = 1.0
        m_band = torch.fft.irfft(mf * mask, n)
        c_band = torch.fft.irfft(cf * mask, n)
        env = torch.sqrt(torch.mean(m_band ** 2) + 1e-12)
        cenv = torch.sqrt(torch.mean(c_band ** 2) + 1e-12)
        out = out + c_band * (env / cenv)
    return out


BLOCKS = {
    "dtmf": ("dtmf_generate", "source", "DTMF dial tones (dtmf.rs)",
             ("sample_rate",)),
    "dtmf_detector": ("dtmf_detect", "demodulator",
                      "Goertzel-bank DTMF decode (dtmf_detector.rs)",
                      ("sample_rate",)),
    "mfcc_extractor": ("mfcc", "measurement",
                       "mel-cepstral features (mfcc_extractor.rs)",
                       ("sample_rate", "n_mfcc")),
    "phase_vocoder": ("phase_vocoder", "filter",
                      "STFT time stretch (phase_vocoder.rs)", ("rate",)),
    "melp_vocoder": ("melp_analyze", "fec",
                     "LPC+pitch vocoder analysis (melp_vocoder.rs)",
                     ("sample_rate", "frame")),
    "speech_formant_tracker": ("formant_track", "measurement",
                               "LPC-root formants "
                               "(speech_formant_tracker.rs)",
                               ("sample_rate",)),
    "psychoacoustic_codec": ("psychoacoustic_encode", "fec",
                             "masking-driven transform codec "
                             "(psychoacoustic_codec.rs)",
                             ("sample_rate", "bits_budget")),
    "speech_voice_restoration": ("voice_restore", "filter",
                                 "spectral-subtraction restoration "
                                 "(speech_voice_restoration.rs)",
                                 ("sample_rate",)),
    "music_pitch_detector": ("pitch_detect", "measurement",
                             "autocorrelation pitch "
                             "(music_pitch_detector.rs)",
                             ("sample_rate",)),
    "music_pitch_tracker": ("pitch_track", "measurement",
                            "pitch contour (music_pitch_tracker.rs)",
                            ("sample_rate", "frame")),
    "acoustic_echo_canceller": ("echo_cancel_nlms", "filter",
                                "NLMS echo canceller "
                                "(acoustic_echo_canceller.rs)",
                                ("n_taps", "mu")),
    "hearing_aid_feedback_suppressor": (
        "feedback_suppress", "filter",
        "delayed-NLMS feedback suppression "
        "(hearing_aid_feedback_suppressor.rs)", ("delay",)),
    "vocoder": ("channel_vocoder", "filter",
                "channel vocoder (vocoder.rs)",
                ("sample_rate", "n_bands")),
}
