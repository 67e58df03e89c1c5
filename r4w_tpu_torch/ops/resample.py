"""Resampling, polyphase channelization and PFB symbol timing recovery.

PyTorch counterpart of ``r4w_tpu.ops.resample`` (filters/polyphase.rs:
PolyphaseDecimator:52, PolyphaseInterpolator:281, Resampler:471,
HalfbandFilter:657; arbitrary_resampler.rs, pfb_channelizer.rs,
pfb_synthesizer.rs, farrow_resampler.rs, wola_channelizer.rs,
pfb_clock_sync.rs). Decimation goes through `filters.decimating_fir`, so
only the kept outputs are computed (the reference filters at the full rate
and then drops samples; the results are the same). Interpolation
zero-stuffs and filters, as the reference does. The arbitrary-ratio and
Farrow resamplers compute every output's position up front in float32, as
the reference does with 64-bit types off; the filterbanks are windowed
products summed on the last axis (no matmul, so no TF32 on the card); the
WOLA synthesis overlap-adds each output's frames in frame order, the
order of the reference's scatter-add. `pfb_clock_sync` is a step loop,
one step per symbol, whose state stays on the samples' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import rounded_sum
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.filters import (_signal, _zero_stuff, decimating_fir, design_lowpass,
                                       fractional_delay_taps, interpolating_fir)
from r4w_tpu_torch.ops.pulse import root_raised_cosine_taps


def polyphase_decompose(taps: np.ndarray, phases: int) -> np.ndarray:
    """(K,) prototype -> (phases, ceil(K/phases)) polyphase bank."""
    k = len(taps)
    pad = (-k) % phases
    t = np.pad(np.asarray(taps), (0, pad))
    return t.reshape(-1, phases).T.copy()  # (phases, taps_per_phase)


def polyphase_decimate(x, taps, factor: int):
    """Decimating FIR: filter and downsample in one pass (polyphase.rs:52).
    Output rate = input/factor."""
    y, _ = decimating_fir(taps, x, factor)
    return y


def polyphase_interpolate(x, taps, factor: int):
    """Interpolating FIR (polyphase.rs:281). Gain-compensated."""
    return interpolating_fir(taps, x, factor)


def rational_resample(x, up: int, down: int, num_taps: int = 128):
    """Rational L/M resampler (polyphase.rs:471 Resampler): zero-stuff by
    L, then a decimating FIR by M that computes only the kept outputs."""
    taps = design_lowpass(num_taps, 0.5 / max(up, down), 1.0)
    y, _ = decimating_fir(taps, _zero_stuff(_signal(x), up), down)
    return y


def halfband_taps(num_taps: int = 31) -> np.ndarray:
    """Halfband lowpass: every other tap zero (polyphase.rs:657)."""
    if num_taps % 2 != 1:
        raise ValueError(f"halfband_taps needs an odd tap count, got {num_taps}")
    t = design_lowpass(num_taps, 0.25, 1.0, window="hamming")
    mid = num_taps // 2
    idx = np.arange(num_taps)
    t = np.where((idx != mid) & ((idx - mid) % 2 == 0), 0.0, t)
    return (t / t.sum()).astype(np.float32)


def halfband_decimate(x, num_taps: int = 31):
    return polyphase_decimate(x, halfband_taps(num_taps), 2)


def _positions(n_out: int, ratio: float, device) -> torch.Tensor:
    """k / ratio for k < n_out in float32 (a float32 division, as the reference's)."""
    return torch.arange(n_out, dtype=REAL_DTYPE, device=device) / real_scalar(ratio, device)


def arbitrary_resample(x, ratio: float, num_taps: int = 8, n_filters: int = 32):
    """Arbitrary-ratio resampler via a bank of fractional-delay subfilters
    (arbitrary_resampler.rs / pfb_arb_resampler.rs).

    output[k] = interp(x, k / ratio) with windowed-sinc interpolation: a
    gather of each output's window and a product with the subfilter its
    quantized fraction selects, from an (n_filters, num_taps) bank.
    """
    x = _signal(x)
    n_in = x.shape[-1]
    n_out = int(np.floor(n_in * ratio))
    pos = _positions(n_out, ratio, x.device)
    base = torch.floor(pos).to(torch.int32)
    frac = pos - base
    fidx = torch.clamp(torch.round(frac * n_filters).to(torch.int64), 0, n_filters - 1)
    bank = torch.as_tensor(np.stack([fractional_delay_taps(d / n_filters, num_taps)
                                     for d in range(n_filters)]), device=x.device)  # (F, K)
    k = num_taps
    half = (k - 1) // 2
    ext = torch.nn.functional.pad(x, (half, k - half))
    windows = ext[..., base.to(torch.int64)[:, None] + torch.arange(k, device=x.device)]
    return torch.sum(windows * bank[fidx], dim=-1)


def pfb_channelizer(x, n_channels: int, taps_per_phase: int = 8):
    """Polyphase filterbank channelizer (pfb_channelizer.rs).

    Splits x into n_channels equally-spaced baseband channels, each at
    fs/n_channels: polyphase filter + FFT across phases. Returns
    (..., n_frames, n_channels) complex.
    """
    x = to_tensor(x, IQ_DTYPE)
    proto = design_lowpass(n_channels * taps_per_phase, 0.5 / n_channels, 1.0)
    bank = torch.as_tensor(polyphase_decompose(proto, n_channels), device=x.device)  # (C, T)
    m = x.shape[-1] // n_channels
    n_frames = m - taps_per_phase + 1
    if n_frames <= 0:
        return x.new_zeros(x.shape[:-1] + (0, n_channels))
    # commutator: sample m*C + c feeds phase c
    frames = x[..., : m * n_channels].reshape(*x.shape[:-1], m, n_channels)
    windows = frames.unfold(-2, taps_per_phase, 1)  # (..., n_frames, C, T)
    filtered = torch.sum(windows * (bank * n_channels), dim=-1)  # scaled for unity passband
    # the FFT across phases maps a tone at +k/C to channel k
    return torch.fft.fft(filtered, dim=-1)


def pfb_synthesizer(channels, taps_per_phase: int = 8):
    """Inverse of pfb_channelizer (pfb_synthesizer.rs): combine
    (..., n_frames, C) channel samples into one stream at C× rate."""
    channels = to_tensor(channels, IQ_DTYPE)
    c = channels.shape[-1]
    spectra = torch.fft.ifft(channels, dim=-1)  # (..., F, C)
    proto = design_lowpass(c * taps_per_phase, 0.5 / c, 1.0)
    bank = torch.as_tensor(polyphase_decompose(proto, c), device=channels.device)  # (C, T)
    # each output frame m, phase p: sum_t bank[p, t]·spectra[m - t, p]
    ext = torch.nn.functional.pad(spectra, (0, 0, taps_per_phase - 1, 0))
    windows = ext.unfold(-2, taps_per_phase, 1)  # (..., F, C, T)
    out = torch.sum(windows * (bank.flip(-1) * c), dim=-1)
    return out.reshape(*out.shape[:-2], -1)


# ---------------------------------------------------------------- Farrow


def farrow_resample(x, ratio: float, order: int = 3):
    """Farrow-structure fractional resampler (farrow_resampler.rs).

    Lagrange interpolation (order 1, 2 or 3) at output positions k/ratio:
    every output's base index and fractional offset mu are computed up
    front, so the resample is one gather and a polynomial evaluation.
    """
    if order not in (1, 2, 3):
        raise ValueError("farrow order must be 1, 2 or 3")
    x = _signal(x)
    n = x.shape[-1]
    n_out = int(np.floor((n - order) * ratio))
    t = _positions(n_out, ratio, x.device)
    base = torch.floor(t).to(torch.int64)
    mu = t - base
    if order == 1:
        i0 = torch.clamp(base, 0, n - 2)
        a = x[..., i0]
        b = x[..., i0 + 1]
        return a + (b - a) * mu
    if order == 2:
        i0 = torch.clamp(base, 1, n - 2)
        m = mu + (base - i0).to(REAL_DTYPE)
        xm, x0, x1 = x[..., i0 - 1], x[..., i0], x[..., i0 + 1]
        c1 = 0.5 * (x1 - xm)
        c2 = 0.5 * (x1 - 2 * x0 + xm)
        return x0 + m * (c1 + m * c2)
    # cubic Lagrange on x[base-1 .. base+2], mu in [0, 1) between the
    # middle two points
    i0 = torch.clamp(base, 1, n - 3)
    mu = mu + (base - i0).to(REAL_DTYPE)  # keep the exact position
    xm1, x0, x1, x2 = x[..., i0 - 1], x[..., i0], x[..., i0 + 1], x[..., i0 + 2]
    six, two = real_scalar(6.0, x.device), real_scalar(2.0, x.device)
    l_m1 = -mu * (mu - 1) * (mu - 2) / six
    l_0 = (mu + 1) * (mu - 1) * (mu - 2) / two
    l_1 = -(mu + 1) * mu * (mu - 2) / two
    l_2 = (mu + 1) * mu * (mu - 1) / six
    return xm1 * l_m1 + x0 * l_0 + x1 * l_1 + x2 * l_2


# ----------------------------------------------------------------- WOLA


def _wola_window(k: int, p: int, window) -> np.ndarray:
    """The analysis window: `window`, or a windowed sinc with its cutoff at
    the channel edge (ones for one tap a channel)."""
    if window is not None:
        return np.asarray(window, np.float64)
    if p == 1:
        return np.ones(k)
    t = np.arange(k * p) - (k * p - 1) / 2.0
    return np.sinc(t / k) * np.hanning(k * p)


def wola_channelize(x, num_channels: int, taps_per_channel: int = 4,
                    window=None):
    """Weighted overlap-add analysis channelizer (wola_channelizer.rs
    process): critically sampled (hop = num_channels); returns
    (..., n_frames, num_channels)."""
    k = num_channels
    p = taps_per_channel
    x = to_tensor(x, IQ_DTYPE)
    w = _wola_window(k, p, window)
    if window is not None and len(w) != k * p:
        raise ValueError("window must have num_channels*taps entries")
    n_frames = x.shape[-1] // k - p + 1
    if n_frames <= 0:
        return x.new_zeros(x.shape[:-1] + (0, k))
    frames = (x[..., : (n_frames - 1) * k + k * p].unfold(-1, k * p, k)
              * torch.as_tensor(w, dtype=REAL_DTYPE, device=x.device))
    folded = frames.reshape(*frames.shape[:-1], p, k).sum(-2)
    return torch.fft.fft(folded, dim=-1)


def wola_synthesize(channels, taps_per_channel: int = 4, window=None):
    """Overlap-add synthesis inverse of wola_channelize
    (wola_channelizer.rs synthesize_frame). With taps_per_channel=1
    (rectangular window) reconstruction is exact."""
    ch = to_tensor(channels, IQ_DTYPE)
    k = ch.shape[-1]
    p = taps_per_channel
    w = _wola_window(k, p, window)
    # normalize so analysis+synthesis windows overlap-add to unity
    wsum = np.zeros(k)
    for i in range(p):
        wsum += (np.asarray(w[i * k:(i + 1) * k]) ** 2
                 if p > 1 else np.ones(k))
    w_syn = torch.as_tensor((w if p > 1 else np.ones(k)) / np.tile(np.maximum(wsum, 1e-12), p),
                            dtype=REAL_DTYPE, device=ch.device)
    frames = torch.fft.ifft(ch, dim=-1)  # (..., F, K)
    expanded = frames.repeat((1,) * (frames.ndim - 1) + (p,)) * w_syn  # (..., F, K·P)
    f = frames.shape[-2]
    out = frames.new_zeros(frames.shape[:-2] + ((f + p - 1) * k,))
    # output k·j + r takes frame j - q's segment q: add them by rising frame
    # (falling segment), the reference scatter-add's order
    for q in range(p - 1, -1, -1):
        seg = expanded[..., q * k:(q + 1) * k].reshape(*frames.shape[:-2], f * k)
        out[..., q * k: q * k + f * k] += seg
    return out


# -------------------------------------------------------- PFB clock sync


REDUCE_WINDOW = 32  # the reference's CPU reductions sum at most this many terms in a row


def _ordered_sum(p: torch.Tensor) -> torch.Tensor:
    """Σ p over the last axis, added in the reference's order: a row of more
    than REDUCE_WINDOW terms is zero-padded evenly at both ends to whole
    windows, each window summed left to right, then the window sums summed
    the same way. In float32 each add rounds as the reference's does, so a
    sum equals the reference's bit for bit on any device (torch.sum adds
    in another order, and then a timing loop's branch choices drift).
    Zeros before or after a window's terms change no sum, so the last
    window's terms are moved behind its zeros and the columns that are
    zero in every window are skipped."""
    n = p.shape[-1]
    while n > REDUCE_WINDOW:
        padded = -(-n // REDUCE_WINDOW) * REDUCE_WINDOW
        front = (padded - n) // 2
        back = padded - n - front
        k = padded // REDUCE_WINDOW
        p = torch.nn.functional.pad(p, (front, back))
        p = p.reshape(*p.shape[:-1], k, REDUCE_WINDOW)
        if back:
            last = torch.roll(p[..., -1:, :], back, dims=-1)
            p = torch.cat([p[..., :-1, :], last], dim=-2)
        skip = min(front, back) if k == 2 else 0
        cols = p[..., skip:].unbind(-1)
        acc = cols[0]
        for col in cols[1:]:
            acc = acc + col
        p, n = acc, k
    cols = p.unbind(-1)
    acc = cols[0]
    for col in cols[1:]:
        acc = acc + col
    return acc


def pfb_clock_sync(x, sps: float, num_filts: int = 32,
                   loop_bw: float = 0.1, rrc_beta: float = 0.35,
                   span_symbols: int = 8):
    """Polyphase-filterbank symbol timing recovery (pfb_clock_sync.rs).

    GNU-Radio style: a bank of `num_filts` fractionally-delayed RRC
    matched filters plus their derivatives; a 2nd-order loop picks the
    branch whose derivative output is orthogonal to the symbol output.
    One step per recovered symbol, its state (phase, rate) kept on the
    samples' device: a step's symbol and derivative outputs are one
    (2, span) product with the chosen branch of both banks, summed in the
    reference's order (`_ordered_sum`), and the error and loop updates
    round where the reference's compiled step rounds (it fuses four
    multiply-adds, `core.hostio.rounded_sum`), so the branch choices,
    symbols and track equal the reference's bit for bit. Returns (symbols
    (S,), timing_track (S,)).
    """
    x = to_tensor(x, IQ_DTYPE)
    if x.ndim != 1:
        raise ValueError("pfb_clock_sync expects a 1-D sample stream")
    dev = x.device
    nf = num_filts
    sps_i = int(round(sps))
    # prototype RRC oversampled by the bank size; branch k is the
    # prototype delayed by k/nf of a sample
    proto = np.asarray(
        root_raised_cosine_taps(sps_i * nf, num_symbols=span_symbols,
                                rolloff=rrc_beta), np.float64) * nf
    span = -(-len(proto) // nf)
    proto = np.pad(proto, (0, span * nf - len(proto)))
    dproto = np.gradient(proto)
    banks = torch.as_tensor(np.stack([proto.reshape(span, nf).T, dproto.reshape(span, nf).T],
                                     axis=1), dtype=REAL_DTYPE, device=dev)  # (NF, 2, span)
    n = x.shape[-1]
    n_sym = int((n - span) // sps) - 2
    if n_sym <= 0:
        return x.new_zeros(0), torch.zeros(0, dtype=REAL_DTYPE, device=dev)
    kp = float(np.float32(loop_bw))  # the gains as the reference's float32 constants
    ki = float(np.float32(0.25 * loop_bw * loop_bw))
    windows = x.unfold(0, span, 1)  # (n - span + 1, span) views
    start = torch.arange(n_sym, dtype=REAL_DTYPE, device=dev) * real_scalar(sps, dev)
    phase = torch.zeros((), dtype=REAL_DTYPE, device=dev)
    rate = torch.zeros((), dtype=REAL_DTYPE, device=dev)
    syms, track = [], []
    for i in range(n_sym):
        pos = start[i] + phase
        fl = torch.floor(pos)
        frac = pos - fl
        # branch k applies a delay of -k/nf, so position base+frac needs
        # branch nf - frac*nf applied one sample later
        braw = torch.remainder(torch.round((1.0 - frac) * nf).to(torch.int64), nf).view(1)
        base = torch.clamp(fl.to(torch.int64) + (braw != 0), 0, n - span - 1)
        # index_select with a one-element index tensor: no host sync
        both = _ordered_sum(windows.index_select(0, base) * banks.index_select(0, braw))[0]
        # energy-gradient TED, power-normalized: positive when late. The
        # reference fuses sr·dr + si·di, sr² + si², rate − ki·err and
        # (phase + rate) − kp·err into multiply-adds: exact float64
        # products, each sum rounded once
        parts = torch.view_as_real(both).double()  # (sr, si), (dr, di)
        cross, power = parts[0] * parts[1], parts[0] * parts[0]
        num = rounded_sum(cross[0], cross[1].float())
        den = rounded_sum(power[0], power[1].float()) + 1e-6
        err = torch.clamp(num / den, -1.0, 1.0)
        err64 = err.double()
        rate = torch.clamp(rounded_sum(err64 * -ki, rate), -0.1, 0.1)
        phase = rounded_sum(err64 * -kp, phase + rate)
        syms.append(both[0])
        track.append(phase)
    return torch.stack(syms), torch.stack(track)
