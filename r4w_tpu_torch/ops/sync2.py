"""Sync, timing and control blocks: the second tier of the synchronization
tail.

PyTorch counterpart of ``r4w_tpu.ops.sync2`` (afc.rs, correlator.rs,
carrier_recovery.rs, clock_recovery_mm.rs, symbol_sync.rs,
timing_error_detector.rs, timing_phase_detector_hybrid.rs,
blind_timing_recovery.rs, feedforward_timing_estimator.rs,
delay_lock_loop.rs, freq_lock_detector.rs, pll_carrier_tracking.rs,
phase_locked_loop_biquad.rs, control_loop.rs, pid_controller.rs,
correlate_estimate.rs, cross_correlator.rs, periodic_autocorrelator.rs,
polyphase_golay_correlator.rs, preamble_gen.rs,
burst_gating_controller.rs, agc_attack_decay.rs, feedforward_agc.rs,
time_sync.rs, network_time_synchronizer.rs, multi_rate_clock.rs,
irig_b_decoder.rs, gps_time.rs, csac_reference_oscillator.rs,
constellation_rotation_detector.rs, tuning_estimator.rs), with the
reference's block table.

Feedback loops are step loops over 1-D streams whose carried state stays
a tensor on the samples' device (no value goes to the host inside a
loop); a step's input products that do not depend on the state are
computed for the whole block first. Feed-forward estimators are single
batched FFT or correlation passes; correlations are FFT products or
elementwise products summed, never a matmul (no TF32 on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.filters import _stack_steps
from r4w_tpu_torch.ops.sync import _integer_pow

# ------------------------------------------------------ carrier control


def _scalar(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=REAL_DTYPE, device=device)


def afc(x, sample_rate: float, alpha: float = 0.01, state: float = 0.0):
    """Automatic frequency control (afc.rs): IIR-averaged phase
    increment drives an NCO that centers the signal. Returns
    (corrected, freq_track_hz, final_freq_hz)."""
    x = to_tensor(x, IQ_DTYPE)
    dphi = torch.angle(x[1:] * torch.conj(x[:-1]))
    dphi = torch.cat([dphi[:1], dphi])
    f, ph = _scalar(state, x.device), _scalar(0.0, x.device)
    f_tr, ph_tr = [], []
    for t in range(dphi.shape[0]):
        f = f + alpha * (dphi[t] - f)
        ph = ph + f
        f_tr.append(f)
        ph_tr.append(ph)
    f_tr, ph_tr = _stack_steps(f_tr, dphi), _stack_steps(ph_tr, dphi)
    y = x * cis(-ph_tr)
    to_hz = sample_rate / (2.0 * np.pi)
    return y, f_tr * to_hz, f * to_hz


def _second_order(x, order: int, g1: float, g2: float, stripped):
    """The carrier loops' recursion over `stripped` samples: err = angle(s·
    e^{-j·order·φ})/order; f += g2·err; φ += f + g1·err. Returns the
    phases and frequencies after each step."""
    ph, f = _scalar(0.0, x.device), _scalar(0.0, x.device)
    order_t = real_scalar(order, x.device)
    phases, freqs = [], []
    for t in range(stripped.shape[0]):
        err = torch.angle(stripped[t] * cis(-order * ph))
        if order != 1:
            err = err / order_t
        f = f + g2 * err
        ph = ph + f + g1 * err
        phases.append(ph)
        freqs.append(f)
    return _stack_steps(phases, x.real), _stack_steps(freqs, x.real)


def carrier_recovery_mpsk(x, order: int = 4, bw: float = 0.02):
    """Decision-directed M-PSK carrier recovery (carrier_recovery.rs):
    raise to the Mth power to strip modulation, track the residual
    with a 2nd-order loop. Returns (corrected, phase_track)."""
    x = to_tensor(x, IQ_DTYPE)
    zeta, wn = 0.707, bw
    phases, _ = _second_order(x, order, 2 * zeta * wn, wn * wn, _integer_pow(x, order))
    return x * cis(-phases), phases


def pll_carrier_tracking(x, loop_bw: float = 0.02, damping: float = 0.707):
    """2nd-order PLL tracking a dominant carrier
    (pll_carrier_tracking.rs). Returns (mixed-down, phase, freq)."""
    x = to_tensor(x, IQ_DTYPE)
    phases, freqs = _second_order(x, 1, 2 * damping * loop_bw, loop_bw * loop_bw, x)
    return x * cis(-phases), phases, freqs


def pll_biquad(x, loop_bw: float = 0.05, damping: float = 0.707):
    """Biquad-form PLL (phase_locked_loop_biquad.rs): same dynamics,
    reported as the filtered instantaneous phase estimate."""
    _, phases, freqs = pll_carrier_tracking(x, loop_bw, damping)
    return phases, freqs


def freq_lock_detector(freqs, tol: float = 0.01, window: int = 64):
    """Declare lock when the loop-frequency variance over a sliding
    window drops below tol^2 (freq_lock_detector.rs)."""
    f = to_tensor(freqs, REAL_DTYPE)
    n = (f.shape[0] // window) * window
    frames = f[:n].reshape(-1, window)
    var = torch.var(frames, dim=-1, unbiased=False)
    return var < tol * tol


def constellation_rotation_detect(x, order: int = 4):
    """Estimate the fixed constellation rotation of an M-PSK burst
    (constellation_rotation_detector.rs): angle of E[x^M]/M."""
    x = to_tensor(x, IQ_DTYPE)
    return torch.angle(torch.mean(_integer_pow(x, order))) / real_scalar(order, x.device)


def tuning_estimate(x, sample_rate: float, nfft: int = 4096):
    """Coarse carrier-offset estimate from the spectrum centroid around
    the peak bin (tuning_estimator.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    win = torch.as_tensor(np.hanning(min(nfft, x.shape[0])), dtype=REAL_DTYPE, device=x.device)
    spec = torch.abs(torch.fft.fft(x[:nfft] * win, nfft)) ** 2
    spec = torch.fft.fftshift(spec)
    freqs = ((torch.arange(nfft, dtype=REAL_DTYPE, device=x.device) - nfft // 2)
             * (sample_rate / nfft))
    k = torch.argmax(spec)
    # the reference's dynamic_slice clamps its start so that 5 bins fit
    lo = torch.clamp(torch.clamp_min(k - 2, 0), max=nfft - 5)
    idx = lo + torch.arange(5, device=x.device)
    w, fr = spec[idx], freqs[idx]
    return torch.sum(w * fr) / torch.clamp_min(torch.sum(w), 1e-12)


# ------------------------------------------------------ timing recovery


def symbol_sync_mm(x, sps: int, bw: float = 0.01, mu0: float = 0.0):
    """Mueller & Müller decision-directed clock recovery producing one
    output per symbol (clock_recovery_mm.rs / symbol_sync.rs).

    A step loop over symbols; the fractional interpolator is a linear
    interpolation between the pair at floor(pos), read by a one-element
    index (no host sync), the pair's start clamped as the reference's
    dynamic_slice clamps it."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[0]
    n_sym = n // sps - 2
    gain_mu = bw
    gain_omega = 0.25 * bw * bw
    pairs = x.unfold(0, 2, 1)  # (n - 1, 2)
    pos = _scalar(mu0, x.device)
    omega = _scalar(float(sps), x.device)
    prev_s = torch.zeros((), dtype=IQ_DTYPE, device=x.device)
    prev_d = torch.zeros((), dtype=IQ_DTYPE, device=x.device)
    limit = n - 2.0
    syms = []
    for _ in range(n_sym):
        fl = torch.floor(pos)
        frac = pos - fl
        i = torch.clamp(fl.to(torch.int64), 0, n - 2).view(1)
        pair = pairs.index_select(0, i)[0]
        s = pair[0] * (1 - frac) + pair[1] * frac
        d = torch.complex(torch.sign(s.real), torch.sign(s.imag))
        err = (prev_d.real * s.real - d.real * prev_s.real
               + prev_d.imag * s.imag - d.imag * prev_s.imag)
        err = torch.clamp(err, -1.0, 1.0)
        omega = omega + gain_omega * err
        pos = torch.clamp_max(pos + omega + gain_mu * err, limit)
        prev_s, prev_d = s, d
        syms.append(s)
    if not syms:
        return x.new_zeros(0)
    return torch.stack(syms)


def timing_error_detector(x, sps: int, kind: str = "gardner"):
    """Per-symbol timing-error sequence without feedback
    (timing_error_detector.rs): diagnostic TED output over a block."""
    x = to_tensor(x, IQ_DTYPE)
    n_sym = x.shape[0] // sps - 1
    idx = torch.arange(n_sym, device=x.device) * sps
    cur = x[idx]
    nxt = x[idx + sps]
    mid = x[idx + sps // 2]
    if kind == "gardner":
        e = ((nxt.real - cur.real) * mid.real
             + (nxt.imag - cur.imag) * mid.imag)
    elif kind == "early_late":
        early = x[torch.clamp_min(idx + sps - sps // 4, 0)]
        late = x[idx + sps + sps // 4 - sps]
        e = (torch.abs(late) - torch.abs(early)) * torch.abs(cur)
    else:
        raise ValueError(f"unknown TED '{kind}'")
    return e.to(REAL_DTYPE)


def hybrid_timing_phase_detector(x, sps: int):
    """Blend Gardner (NDA) and M&M-style (DD) error signals — the
    hybrid detector (timing_phase_detector_hybrid.rs). Weighting moves
    toward DD as SNR (decision confidence) rises."""
    g = timing_error_detector(x, sps, "gardner")
    x = to_tensor(x, IQ_DTYPE)
    n_sym = x.shape[0] // sps - 1
    idx = torch.arange(n_sym, device=x.device) * sps
    cur, nxt = x[idx], x[idx + sps]
    d_cur = torch.complex(torch.sign(cur.real), torch.sign(cur.imag))
    d_nxt = torch.complex(torch.sign(nxt.real), torch.sign(nxt.imag))
    mm = (d_cur.real * nxt.real - d_nxt.real * cur.real
          + d_cur.imag * nxt.imag - d_nxt.imag * cur.imag)
    mag = torch.abs(cur)
    ten = real_scalar(10.0, x.device)
    conf = torch.clamp_max(torch.mean(mag) / torch.clamp_min(torch.std(mag, unbiased=False),
                                                             1e-6), 10.0) / ten
    return (1.0 - conf) * g + conf * mm.to(REAL_DTYPE)


def feedforward_timing_estimate(x, sps: int):
    """Oerder–Meyr square-law feedforward symbol-timing estimator
    (feedforward_timing_estimator.rs / blind_timing_recovery.rs):
    tau = -angle( Σ |x[n]|^2 e^{-j2πn/sps} ) · sps/2π — one reduction,
    no feedback loop."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[0]
    w = cis(-2.0 * np.pi * torch.arange(n, dtype=REAL_DTYPE, device=x.device)
            / real_scalar(sps, x.device))
    c = torch.sum((torch.abs(x) ** 2).to(IQ_DTYPE) * w)
    tau = -torch.angle(c) / real_scalar(2.0 * np.pi, x.device) * sps
    return torch.remainder(tau + sps, real_scalar(sps, x.device))


def blind_timing_recover(x, sps: int):
    """Feedforward recovery: estimate tau then decimate at the nearest
    integer offset (blind_timing_recovery.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    tau = feedforward_timing_estimate(x, sps)
    off = torch.remainder(torch.round(tau).to(torch.int64), sps)
    n_sym = (x.shape[0] - sps) // sps
    idx = off + torch.arange(n_sym, device=x.device) * sps
    return x[idx], tau


def delay_lock_loop(x, ref, sps: int, bw: float = 0.01):
    """Code-delay tracking DLL over a known reference sequence
    (delay_lock_loop.rs): early/late correlators a half-symbol apart,
    64 steps; each correlator reads its window by a one-element index
    (no host sync), clamped as the reference's dynamic_slice."""
    x = to_tensor(x, IQ_DTYPE)
    ref = to_tensor(ref, IQ_DTYPE, x.device)
    m = ref.shape[0]
    windows = x.unfold(0, m, 1)  # (n - m + 1, m)
    last = x.shape[0] - m

    def corr_at(delay):
        i = torch.clamp(torch.round(delay).to(torch.int64), 0, last).view(1)
        seg = windows.index_select(0, i)[0]
        return torch.abs(torch.sum(torch.conj(ref) * seg))

    delay = _scalar(float(sps), x.device)
    track = []
    for _ in range(64):
        e = corr_at(delay - sps / 2)
        late = corr_at(delay + sps / 2)
        disc = (e - late) / torch.clamp_min(e + late, 1e-9)
        delay = delay - bw * disc * sps
        track.append(delay)
    return delay, torch.stack(track)


# -------------------------------------------------------- correlators


def cross_correlator(a, b, normalize: bool = True):
    """Full FFT cross-correlation with optional normalization
    (cross_correlator.rs). Returns (lags, corr)."""
    a = to_tensor(a, IQ_DTYPE)
    b = to_tensor(b, IQ_DTYPE, a.device)
    la, lb = a.shape[0], b.shape[0]
    nfft = 1 << (la + lb - 2).bit_length()
    c = torch.fft.ifft(torch.fft.fft(a, nfft) * torch.conj(torch.fft.fft(b, nfft)))
    c = torch.cat([c[-(lb - 1):], c[:la]])  # lb == 1 takes all of c first, as the reference
    if normalize:
        c = c / torch.clamp_min(torch.sqrt(torch.sum(torch.abs(a) ** 2)
                                           * torch.sum(torch.abs(b) ** 2)), 1e-12)
    lags = torch.arange(-(lb - 1), la, device=a.device)
    return lags, c


def correlate_estimate(x, pattern, threshold: float = 0.7):
    """Detect a known pattern and estimate its offset + phase + gain
    (correlate_estimate.rs)."""
    lags, c = cross_correlator(x, pattern)
    mag = torch.abs(c)
    k = torch.argmax(mag)
    found = mag[k] > threshold
    return found, lags[k], torch.angle(c[k]), mag[k]


def periodic_autocorrelator(x, period: int, n_periods: int = 8):
    """Average correlation between the block and itself shifted by k
    periods (periodic_autocorrelator.rs): detects cyclic structure."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[0] - period * n_periods
    base = x[:n]
    vals = []
    for k in range(1, n_periods + 1):
        seg = x[k * period:k * period + n]
        vals.append(torch.sum(torch.conj(base) * seg)
                    / torch.clamp_min(torch.sqrt(torch.sum(torch.abs(base) ** 2)
                                                 * torch.sum(torch.abs(seg) ** 2)), 1e-12))
    return torch.stack(vals)


def golay_complementary_pair(n: int = 32, device=None):
    """Golay complementary pair by recursive construction
    (polyphase_golay_correlator.rs). len must be a power of two."""
    a = np.array([1.0])
    b = np.array([1.0])
    while a.shape[0] < n:
        a, b = np.concatenate([a, b]), np.concatenate([a, -b])
    return to_tensor(a, REAL_DTYPE, device), to_tensor(b, REAL_DTYPE, device)


def golay_correlate(x, n: int = 32):
    """Correlate against a Golay pair; the pair's summed
    autocorrelation is a perfect 2n·δ — sidelobe-free detection
    (polyphase_golay_correlator.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    ga, gb = golay_complementary_pair(n, x.device)
    _, ca = cross_correlator(x, ga.to(IQ_DTYPE), normalize=False)
    _, cb = cross_correlator(x, gb.to(IQ_DTYPE), normalize=False)
    return ca, cb


def preamble_gen(kind: str = "alternating", n_bits: int = 64, device=None):
    """Standard preamble bit patterns (preamble_gen.rs)."""
    if kind == "alternating":
        return to_tensor([1, 0] * (n_bits // 2), torch.int32, device)
    if kind == "barker13":
        b = [1, 1, 1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1]
        return to_tensor((b * (n_bits // 13 + 1))[:n_bits], torch.int32, device)
    if kind == "golay":
        a, _ = golay_complementary_pair(n_bits, device)
        return torch.floor_divide(a + 1, 2).to(torch.int32)
    raise ValueError(f"unknown preamble kind '{kind}'")


# ------------------------------------------------------------ AGC / gating


def feedforward_agc(x, target: float = 1.0, window: int = 64):
    """Block-wise feedforward AGC (feedforward_agc.rs): per-window RMS
    normalization — no feedback transient."""
    x = to_tensor(x)
    n = (x.shape[0] // window) * window
    frames = x[:n].reshape(-1, window)
    tgt = real_scalar(target, x.device)
    rms = torch.sqrt(torch.mean(torch.abs(frames) ** 2, dim=-1, keepdim=True))
    out = frames * (tgt / torch.clamp_min(rms, 1e-12)).to(x.dtype)
    if x.shape[0] > n:
        tail_rms = torch.sqrt(torch.mean(torch.abs(x[n:]) ** 2))
        tail = x[n:] * (tgt / torch.clamp_min(tail_rms, 1e-12)).to(x.dtype)
    else:
        tail = x[n:]
    return torch.cat([out.reshape(-1), tail])


def agc_attack_decay(x, target: float = 1.0, attack: float = 0.1,
                     decay: float = 0.01, state: float = 1.0):
    """AGC with separate attack/decay rates (agc_attack_decay.rs)."""
    x = to_tensor(x)
    mag = torch.abs(x).to(REAL_DTYPE)
    gain = _scalar(state, x.device)
    gains = []
    for t in range(mag.shape[0]):
        err = target - mag[t] * gain
        rate = torch.where(err < 0, attack, decay)
        gain = torch.clamp_min(gain + rate * err, 1e-6)
        gains.append(gain)
    return x * _stack_steps(gains, mag).to(x.dtype), gain


def burst_gating_controller(power_db, open_db: float, close_db: float,
                            hang: int = 16):
    """Burst TX/RX gate with hang time (burst_gating_controller.rs):
    opens above open_db, closes only after ``hang`` samples below
    close_db."""
    p = to_tensor(power_db, REAL_DTYPE)
    above, below = p > open_db, p < close_db  # every step's comparisons at once
    gate = torch.zeros((), dtype=torch.int32, device=p.device)
    cnt = torch.zeros((), dtype=torch.int32, device=p.device)
    gates = []
    for t in range(p.shape[0]):
        cnt = torch.where(above[t], 0, torch.where(below[t], cnt + 1, 0))
        gate = torch.where(above[t], 1, torch.where(cnt >= hang, 0, gate))
        gates.append(gate)
    if not gates:
        return torch.zeros(0, dtype=torch.int32, device=p.device)
    return torch.stack(gates).to(torch.int32)


# ------------------------------------------------------- control loops


def pid_controller(error, kp: float, ki: float, kd: float,
                   state=(0.0, 0.0)):
    """Discrete PID over an error sequence (pid_controller.rs).
    Returns (control, (integral, last_error))."""
    e = to_tensor(error, REAL_DTYPE)
    integ, prev = _scalar(state[0], e.device), _scalar(state[1], e.device)
    u = []
    for t in range(e.shape[0]):
        et = e[t]
        integ = integ + et
        deriv = et - prev
        u.append(kp * et + ki * integ + kd * deriv)
        prev = et
    return _stack_steps(u, e), (integ, prev)


def control_loop_2nd(error, loop_bw: float, damping: float = 0.707,
                     state=(0.0, 0.0)):
    """Generic 2nd-order loop filter: phase+frequency integrators — the
    shared core of PLL/FLL/DLL gains (control_loop.rs)."""
    g1 = 2 * damping * loop_bw
    g2 = loop_bw * loop_bw
    e = to_tensor(error, REAL_DTYPE)
    ph, f = _scalar(state[0], e.device), _scalar(state[1], e.device)
    phs, fs = [], []
    for t in range(e.shape[0]):
        f = f + g2 * e[t]
        ph = ph + f + g1 * e[t]
        phs.append(ph)
        fs.append(f)
    return _stack_steps(phs, e), _stack_steps(fs, e), (ph, f)


# --------------------------------------------------------- time & clocks


@dataclasses.dataclass
class GpsTime:
    """GPS week + seconds-of-week <-> UTC-ish conversions (gps_time.rs).
    Leap seconds handled via an explicit offset (18 s as of 2017)."""
    week: int
    tow: float

    GPS_EPOCH_UNIX = 315964800.0     # 1980-01-06T00:00:00Z
    LEAP_SECONDS = 18.0

    @classmethod
    def from_unix(cls, t: float) -> "GpsTime":
        g = t - cls.GPS_EPOCH_UNIX + cls.LEAP_SECONDS
        week = int(g // 604800)
        return cls(week=week, tow=g - week * 604800)

    def to_unix(self) -> float:
        return (self.week * 604800 + self.tow
                + self.GPS_EPOCH_UNIX - self.LEAP_SECONDS)


def _irig_b_symbols(seconds_of_day: int, frame_rate: int = 100):
    """(widths, symbols) numpy arrays of an IRIG-B frame."""
    sec = seconds_of_day % 60
    minute = (seconds_of_day // 60) % 60
    hour = seconds_of_day // 3600

    def bcd(v, bits):
        return [(v >> i) & 1 for i in range(bits)]

    sym = np.zeros(frame_rate)
    sym[0] = 2  # reference marker
    # seconds: units (bits 1-4), tens (bits 6-8); position 5 is a 0
    u, t = sec % 10, sec // 10
    vals = bcd(u, 4) + [0] + bcd(t, 3)
    sym[1:9] = vals
    sym[9] = 2
    u, t = minute % 10, minute // 10
    vals = bcd(u, 4) + [0] + bcd(t, 3) + [0]
    sym[10:18] = vals[:8]
    sym[19] = 2
    u, t = hour % 10, hour // 10
    vals = bcd(u, 4) + [0] + bcd(t, 2) + [0, 0]
    sym[20:28] = vals[:8]
    for p in range(29, frame_rate, 10):
        sym[p] = 2
    widths = np.where(sym == 2, 0.8, np.where(sym == 1, 0.5, 0.2))
    return widths, sym


def irig_b_encode(seconds_of_day: int, frame_rate: int = 100, device=None):
    """Encode an IRIG-B time-of-day frame as pulse-width symbols
    (irig_b_decoder.rs counterpart): 100 symbols; markers P at
    positions 0,9,19,...,99; BCD seconds/minutes/hours fields.
    Symbol widths: 0 -> 0.2, 1 -> 0.5, marker -> 0.8 of a bit period.
    Returns (widths float32, symbols int32)."""
    widths, sym = _irig_b_symbols(seconds_of_day, frame_rate)
    return to_tensor(widths, REAL_DTYPE, device), to_tensor(sym, torch.int32, device)


def irig_b_decode(widths):
    """Decode pulse widths back to time of day (irig_b_decoder.rs)."""
    w = widths.cpu().numpy() if isinstance(widths, torch.Tensor) else np.asarray(widths)
    sym = np.where(w > 0.65, 2, np.where(w > 0.35, 1, 0))

    def debcd(bits):
        return sum(b << i for i, b in enumerate(bits))

    sec = debcd(sym[1:5]) + 10 * debcd(sym[6:9])
    minute = debcd(sym[10:14]) + 10 * debcd(sym[15:18])
    hour = debcd(sym[20:24]) + 10 * debcd(sym[25:27])
    return hour * 3600 + minute * 60 + sec


def network_time_offset(t1: float, t2: float, t3: float, t4: float):
    """NTP-style offset/delay from a four-timestamp exchange
    (network_time_synchronizer.rs / time_sync.rs):
    offset = ((t2-t1)+(t3-t4))/2, delay = (t4-t1)-(t3-t2)."""
    offset = ((t2 - t1) + (t3 - t4)) / 2.0
    delay = (t4 - t1) - (t3 - t2)
    return offset, delay


class MultiRateClock:
    """Derive multiple integer-divided sample clocks from one master
    counter (multi_rate_clock.rs)."""

    def __init__(self, master_rate: float, divisors: tuple[int, ...]):
        self.master_rate = master_rate
        self.divisors = divisors
        self.count = 0

    def advance(self, n: int):
        """Advance n master ticks; returns ticks elapsed per derived
        clock."""
        out = []
        for d in self.divisors:
            out.append((self.count + n) // d - self.count // d)
        self.count += n
        return tuple(out)

    def time(self) -> float:
        return self.count / self.master_rate


def csac_allan_deviation(freq_error, tau_samples: int):
    """Overlapping Allan deviation of a fractional-frequency series at
    one averaging interval (csac_reference_oscillator.rs health
    metric)."""
    y = to_tensor(freq_error, REAL_DTYPE)
    m = tau_samples
    n = (y.shape[0] // m) * m
    means = torch.mean(y[:n].reshape(-1, m), dim=-1)
    d = torch.diff(means)
    return torch.sqrt(0.5 * torch.mean(d * d))


BLOCKS = {
    "afc": ("afc", "sync", "automatic frequency control (afc.rs)",
            ("sample_rate", "alpha")),
    "carrier_recovery": ("carrier_recovery_mpsk", "sync",
                         "Mth-power carrier recovery "
                         "(carrier_recovery.rs)", ("order", "bw")),
    "pll_carrier_tracking": ("pll_carrier_tracking", "sync",
                             "2nd-order carrier PLL "
                             "(pll_carrier_tracking.rs)", ("loop_bw",)),
    "pll_biquad": ("pll_biquad", "sync",
                   "biquad PLL (phase_locked_loop_biquad.rs)",
                   ("loop_bw",)),
    "freq_lock_detector": ("freq_lock_detector", "sync",
                           "loop lock detector (freq_lock_detector.rs)",
                           ("tol", "window")),
    "constellation_rotation_detector": (
        "constellation_rotation_detect", "sync",
        "M-PSK rotation estimate (constellation_rotation_detector.rs)",
        ("order",)),
    "tuning_estimator": ("tuning_estimate", "sync",
                         "spectrum-centroid offset (tuning_estimator.rs)",
                         ("sample_rate",)),
    "clock_recovery_mm": ("symbol_sync_mm", "sync",
                          "Mueller&Muller clock recovery "
                          "(clock_recovery_mm.rs / symbol_sync.rs)",
                          ("sps", "bw")),
    "timing_error_detector": ("timing_error_detector", "sync",
                              "Gardner/early-late TED "
                              "(timing_error_detector.rs)",
                              ("sps", "kind")),
    "hybrid_timing_detector": (
        "hybrid_timing_phase_detector", "sync",
        "NDA/DD blended TED (timing_phase_detector_hybrid.rs)",
        ("sps",)),
    "feedforward_timing": ("feedforward_timing_estimate", "sync",
                           "Oerder-Meyr square-law timing "
                           "(feedforward_timing_estimator.rs)",
                           ("sps",)),
    "blind_timing_recovery": ("blind_timing_recover", "sync",
                              "feedforward timing + decimate "
                              "(blind_timing_recovery.rs)", ("sps",)),
    "delay_lock_loop": ("delay_lock_loop", "sync",
                        "early/late code DLL (delay_lock_loop.rs)",
                        ("sps", "bw")),
    "cross_correlator": ("cross_correlator", "measurement",
                         "normalized FFT xcorr (cross_correlator.rs)"),
    "correlate_estimate": ("correlate_estimate", "sync",
                           "pattern offset/phase/gain "
                           "(correlate_estimate.rs)", ("threshold",)),
    "periodic_autocorrelator": ("periodic_autocorrelator",
                                "measurement",
                                "cyclic-structure detector "
                                "(periodic_autocorrelator.rs)",
                                ("period", "n_periods")),
    "golay_correlator": ("golay_correlate", "sync",
                         "sidelobe-free Golay pair correlator "
                         "(polyphase_golay_correlator.rs)", ("n",)),
    "preamble_gen": ("preamble_gen", "source",
                     "standard preamble patterns (preamble_gen.rs)",
                     ("kind", "n_bits")),
    "feedforward_agc": ("feedforward_agc", "filter",
                        "block RMS AGC (feedforward_agc.rs)",
                        ("target", "window")),
    "agc_attack_decay": ("agc_attack_decay", "filter",
                         "attack/decay AGC (agc_attack_decay.rs)",
                         ("target", "attack", "decay")),
    "burst_gating_controller": ("burst_gating_controller", "sync",
                                "hang-time burst gate "
                                "(burst_gating_controller.rs)",
                                ("open_db", "close_db", "hang")),
    "pid_controller": ("pid_controller", "math",
                       "discrete PID (pid_controller.rs)",
                       ("kp", "ki", "kd")),
    "control_loop": ("control_loop_2nd", "math",
                     "2nd-order loop filter core (control_loop.rs)",
                     ("loop_bw", "damping")),
    "gps_time": ("GpsTime", "math",
                 "GPS week/TOW conversions (gps_time.rs)"),
    "irig_b": ("irig_b_encode", "source",
               "IRIG-B frame encode/decode (irig_b_decoder.rs)"),
    "network_time_sync": ("network_time_offset", "math",
                          "NTP 4-timestamp offset/delay "
                          "(network_time_synchronizer.rs)"),
    "multi_rate_clock": ("MultiRateClock", "math",
                         "divided sample clocks (multi_rate_clock.rs)",
                         ("master_rate", "divisors")),
    "csac_allan_deviation": ("csac_allan_deviation", "measurement",
                             "Allan deviation "
                             "(csac_reference_oscillator.rs)",
                             ("tau_samples",)),
}
