"""FIR filters and FIR design.

PyTorch counterpart of the FIR part of ``r4w_tpu.ops.filters``. Every
filter is a block function ``f(params, x, state) -> (y, state)``: streaming
parity comes from carrying the last K-1 input samples between blocks,
while a block's leading axes are a batch. Samples are on the last axis;
complex signals are filtered in one pass (real taps on both parts).

Every FIR runs through one kernel, `kernels.fir.fir_decimate_dispatch`
(the plain version on a CPU tensor, the Hopper kernel on a CUDA tensor),
as a correlation of the stream state ‖ x with the reversed taps:
``fir_decimate(x, taps[::-1], f, state) == fir_filter(taps, x,
state)[0][..., ::f]``, so a decimating FIR computes only the outputs it
keeps. The kernel reads the state beside the block, so on the card no
filter concatenates them, and a missing state is read as zeros, never
allocated. The new state, the last K-1 samples of state ‖ x, is a copy of
x's tail (`_next_state`). The dense FIR is the same call at f = 1; no
convolution, and so no cuDNN TF32, is on the path. The oscillator of
`freq_xlating_fir` is `kernels.nco.nco_mix_dispatch`.

The design functions are numpy copies of the reference's and return the
same float32 (or float64) arrays bit for bit.

The one-pole filters (`single_pole_iir`, `dc_blocker`) run through
`kernels.recurrence.first_order_recurrence_dispatch`: the plain step loop
on a CPU tensor, one launch of the Hopper kernel on a CUDA tensor, with the
carried state a tensor on the samples' device. Each step rounds as the
reference's compiled scan, which fuses a multiply and an add:
`single_pole_iir` is fma(α, x[n], round((1−α)·y)) (kind ``one_pole``) and
`dc_blocker` fma(α, y, x[n] − x[n-1]) (kind ``linear``, the difference
computed for the whole block first). `iir_filter` of general order stays
a step loop over the samples, as the reference's ``lax.scan`` is: each
step's input products are computed for the whole block first (the same
float32 products the reference's step makes), so a step is the few
launches of the recursion itself. The CIC integrators are cumulative sums with carried
accumulators (`_cumsum`); the median filter sorts edge-padded windows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor
from r4w_tpu_torch.core.windows import _np_window
from r4w_tpu_torch.kernels.fir import fir_decimate_dispatch
from r4w_tpu_torch.kernels.nco import nco_mix_dispatch
from r4w_tpu_torch.kernels.recurrence import first_order_recurrence_dispatch, initial_state


def _signal(x) -> torch.Tensor:
    """`x` as float32 or complex64 (numpy and lists on the default device)."""
    x = to_tensor(x)
    return x.to(IQ_DTYPE) if x.is_complex() else x.to(REAL_DTYPE)


def _taps(taps, like: torch.Tensor) -> torch.Tensor:
    """`taps` as a float32 tensor on `like`'s device."""
    return to_tensor(taps, REAL_DTYPE, device=like.device)


def _next_state(state, x: torch.Tensor, k: int) -> torch.Tensor:
    """The last K-1 samples of state ‖ x, zeros for a missing state: a copy of
    x's tail when N >= K-1, so that a caller who refills x's buffer leaves
    the state alone; a small concatenation when N < K-1."""
    keep, n = k - 1, x.shape[-1]
    if n >= keep:
        return x[..., n - keep:].clone(memory_format=torch.contiguous_format)
    if state is None:
        state = x.new_zeros(x.shape[:-1] + (keep,))
    return torch.cat([state[..., n:], x], dim=-1)


def _fir(taps: torch.Tensor, x: torch.Tensor, factor: int, state):
    """(every factor-th output of the FIR over state ‖ x, new state)."""
    if state is not None:
        state = to_tensor(state, x.dtype, device=x.device)
    y = fir_decimate_dispatch(x, taps.flip(0), factor, state, zero_state=state is None)
    return y, _next_state(state, x, taps.shape[0])


def fir_filter(taps, x, state=None):
    """Streaming FIR: y[n] = Σ taps[k]·x[n-k] (filters/fir.rs:38).

    state: previous (K-1) input samples (zeros initially).
    Returns (y same length as x, new state). Complex-safe.
    """
    x = _signal(x)
    return _fir(_taps(taps, x), x, 1, state)


def fir_apply(taps, x):
    """One-shot FIR with zero initial state (returns y only)."""
    y, _ = fir_filter(taps, x)
    return y


def decimating_fir(taps, x, factor: int, state=None):
    """FIR + keep every factor-th output (decimating_fir.rs), computing
    only the kept outputs. Returns (y, new state)."""
    x = _signal(x)
    return _fir(_taps(taps, x), x, factor, state)


def _zero_stuff(x: torch.Tensor, factor: int) -> torch.Tensor:
    """x·factor at every factor-th sample, zeros between (gain-compensated)."""
    up = torch.zeros(x.shape[:-1] + (x.shape[-1] * factor,), dtype=x.dtype, device=x.device)
    up[..., ::factor] = x * factor
    return up


def interpolating_fir(taps, x, factor: int):
    """Zero-stuff by factor then FIR (interp_fir.rs). Gain = factor."""
    return fir_apply(taps, _zero_stuff(_signal(x), factor))


def freq_xlating_fir(taps, x, center_freq, sample_rate, state=None, phase0=0.0):
    """Mix to baseband then lowpass+FIR (freq_xlating_fir.rs).

    Returns (y, new state, phase0 + w·N) with w = -2π·center/fs, the phase
    to pass as `phase0` with the next block.
    """
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    w = -2.0 * math.pi * center_freq / sample_rate
    shifted = nco_mix_dispatch(x, -center_freq, sample_rate, phase0=phase0)
    y, state = fir_filter(taps, shifted, state)
    return y, state, phase0 + w * n


def moving_average(x, length: int, state=None):
    """Boxcar moving average (moving_average.rs) as FIR."""
    x = _signal(x)
    taps = torch.full((length,), 1.0 / length, dtype=REAL_DTYPE, device=x.device)
    return fir_filter(taps, x, state)


def moving_rms(x, length: int):
    p, _ = moving_average(torch.abs(_signal(x)) ** 2, length)
    return torch.sqrt(p)


def iir_filter(b, a, x, zi=None):
    """Direct-form-II-transposed IIR (filters/iir.rs).

    b, a: transfer function coefficients (a[0] normalized to 1).
    zi: (..., max(len(a),len(b))-1) initial state. Returns (y, zf).
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b = b / a[0]
    a = a / a[0]
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    x = _signal(x)
    bt = torch.as_tensor(b, dtype=REAL_DTYPE, device=x.device)
    at = torch.as_tensor(a, dtype=REAL_DTYPE, device=x.device)
    z = (x.new_zeros(x.shape[:-1] + (n - 1,)) if zi is None
         else to_tensor(zi, x.dtype, device=x.device))
    # the step's input products b[k]·x[n], for every n at once
    b0x = bt[0] * x
    bx = bt[1:] * x[..., None]  # (..., N, n-1)
    zero = z.new_zeros(z.shape[:-1] + (1,))
    ys = []
    for t in range(x.shape[-1]):
        yn = b0x[..., t] + z[..., 0]
        z = (bx[..., t, :] - at[1:] * yn[..., None]) + torch.cat([z[..., 1:], zero], dim=-1)
        ys.append(yn)
    return _stack_steps(ys, x), z


def _stack_steps(ys: list, like: torch.Tensor) -> torch.Tensor:
    """The per-step outputs of a loop over `like`'s last axis, on that axis."""
    if not ys:
        return like.new_zeros(like.shape)
    return torch.stack(ys, dim=-1)


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median of all elements; the mean of the two middle ones at an even
    count, as the reference's median (`torch.median` takes the lower)."""
    s = torch.sort(v.reshape(-1)).values
    return (s[(s.numel() - 1) // 2] + s[s.numel() // 2]) * 0.5


def single_pole_iir(alpha: float, x, state=None):
    """y[n] = α·x[n] + (1-α)·y[n-1] (single_pole_iir.rs)."""
    x = _signal(x)
    y = first_order_recurrence_dispatch(x, "one_pole", alpha, 1.0 - alpha, state)
    if x.shape[-1] == 0:
        return y, initial_state(x, state)
    return y, y[..., -1]


def dc_blocker(x, alpha: float = 0.995, state=None):
    """y[n] = x[n] - x[n-1] + α·y[n-1] (dc_blocker.rs). Returns (y, (x_last, y_last))."""
    x = _signal(x)
    if state is None:
        xprev = x.new_zeros(x.shape[:-1])
        yprev = None
    else:
        xprev = to_tensor(state[0], x.dtype, x.device)
        yprev = to_tensor(state[1], x.dtype, x.device)
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape), (xprev, initial_state(x, yprev))
    diff = x - torch.cat([xprev[..., None].expand(x.shape[:-1] + (1,)), x[..., :-1]], dim=-1)
    y = first_order_recurrence_dispatch(diff, "linear", alpha, state=yprev)
    return y, (x[..., -1], y[..., -1])


def _cumsum(v: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in v's dtype. Floats accumulate in
    float64 (complex128) and round back: the CPU's own accumulation, made
    the card's too, whose float32 scan would round every partial sum."""
    if v.is_complex() or v.is_floating_point():
        wide = torch.complex128 if v.is_complex() else torch.float64
        return torch.cumsum(v.to(wide), dim=-1).to(v.dtype)
    return torch.cumsum(v, dim=-1, dtype=v.dtype)


def cic_decimator(x, rate: int, stages: int = 3, state=None):
    """CIC decimating filter (cic_filter.rs): N integrators @ input rate,
    decimate by R, N combs @ output rate (differential delay 1).

    Gain = R^N. Integrators run as cumsum chains per block with carried
    accumulators; combs as diff with carried last samples.
    """
    x = to_tensor(x)
    if state is None:
        integ = x.new_zeros((stages,) + x.shape[:-1])
        comb = x.new_zeros((stages,) + x.shape[:-1])
    else:
        integ, comb = (to_tensor(s, x.dtype, x.device) for s in state)
    v = x
    new_integ = []
    for s in range(stages):
        v = _cumsum(v) + integ[s][..., None]
        new_integ.append(v[..., -1])
    w = v[..., rate - 1 :: rate]
    new_comb = []
    for s in range(stages):
        prev = torch.cat([comb[s][..., None], w[..., :-1]], dim=-1)
        new_comb.append(w[..., -1])
        w = w - prev
    return w, (torch.stack(new_integ), torch.stack(new_comb))


def median_filter(x, length: int):
    """Sliding median (median_filter.rs), edge-padded. An even length takes
    the mean of the two middle values, as the reference's median does (not
    the lower one, as `torch.median` would)."""
    x = to_tensor(x)
    n, half = x.shape[-1], length // 2
    idx = (torch.arange(n, device=x.device)[:, None] - half
           + torch.arange(length, device=x.device)[None, :]).clamp(0, n - 1)
    windows = torch.sort(x[..., idx], dim=-1).values
    lo, hi = windows[..., (length - 1) // 2], windows[..., length // 2]
    return (lo + hi) * 0.5


def hilbert_fir_taps(num_taps: int = 65, window: str = "hamming") -> np.ndarray:
    """Type-III FIR Hilbert transformer taps (hilbert.rs)."""
    m = num_taps // 2
    n = np.arange(num_taps) - m
    h = np.zeros(num_taps)
    odd = n % 2 != 0
    h[odd] = 2.0 / (np.pi * n[odd])
    return (h * _np_window(window, num_taps)).astype(np.float32)


def fractional_delay_taps(delay: float, num_taps: int = 31) -> np.ndarray:
    """Windowed-sinc fractional delay (fractional_delay.rs)."""
    m = (num_taps - 1) / 2.0
    n = np.arange(num_taps)
    h = np.sinc(n - m - delay)
    return (h * _np_window("hamming", num_taps)).astype(np.float32)


# --------------------------------------------------------------------------
# FIR design (filters/remez.rs is Parks-McClellan; windowed-sinc design
# covers the same lowpass/highpass/bandpass use sites)
# --------------------------------------------------------------------------


def design_lowpass(num_taps: int, cutoff: float, sample_rate: float,
                   window: str = "hamming") -> np.ndarray:
    m = (num_taps - 1) / 2.0
    n = np.arange(num_taps)
    fc = cutoff / sample_rate  # normalized (cycles/sample)
    h = 2.0 * fc * np.sinc(2.0 * fc * (n - m))
    h = h * _np_window(window, num_taps)
    return (h / h.sum()).astype(np.float32)


def design_highpass(num_taps: int, cutoff: float, sample_rate: float,
                    window: str = "hamming") -> np.ndarray:
    lp = design_lowpass(num_taps, cutoff, sample_rate, window)
    hp = -lp
    hp[(num_taps - 1) // 2] += 1.0
    return hp.astype(np.float32)


def design_bandpass(num_taps: int, f_lo: float, f_hi: float,
                    sample_rate: float, window: str = "hamming") -> np.ndarray:
    m = (num_taps - 1) / 2.0
    n = np.arange(num_taps)
    center = (f_lo + f_hi) / 2.0 / sample_rate
    lp = design_lowpass(num_taps, (f_hi - f_lo) / 2.0, sample_rate, window)
    return (2.0 * lp * np.cos(2.0 * np.pi * center * (n - m))).astype(
        np.float32
    )


def design_equiripple(num_taps: int, bands, desired, weights=None,
                      grid_density: int = 16, iters: int = 60
                      ) -> np.ndarray:
    """Equiripple linear-phase FIR design (filters/remez.rs role).

    Same problem as Parks-McClellan — minimax multiband approximation —
    solved with Lawson's iteratively-reweighted least squares on a dense
    cosine-basis grid. Host-side numpy float64 design.

    bands: [(f_lo, f_hi), ...] in normalized frequency [0, 0.5];
    desired: target gain per band; weights: relative ripple weights.
    """
    if num_taps % 2 == 0:
        raise ValueError("design_equiripple needs an odd tap count")
    bands = list(bands)
    desired = list(desired)
    if len(bands) != len(desired):
        raise ValueError("bands and desired must have equal length")
    w_bands = list(weights) if weights is not None else [1.0] * len(bands)
    half = num_taps // 2
    freqs = []
    target = []
    wgrid = []
    for (lo, hi), d, wb in zip(bands, desired, w_bands):
        npts = max(int((hi - lo) * 2 * grid_density * num_taps), 8)
        f = np.linspace(lo, hi, npts)
        freqs.append(f)
        target.append(np.full(npts, float(d)))
        wgrid.append(np.full(npts, float(wb)))
    f = np.concatenate(freqs)
    d = np.concatenate(target)
    wb = np.concatenate(wgrid)
    # amplitude response of a symmetric type-I filter:
    # A(f) = c0 + 2 sum_k c_k cos(2 pi f k)
    basis = np.cos(2 * np.pi * np.outer(f, np.arange(half + 1)))
    basis[:, 1:] *= 2.0
    lawson = np.ones_like(f)
    c = None
    for _ in range(iters):
        w = np.sqrt(lawson) * wb
        c, *_ = np.linalg.lstsq(basis * w[:, None], d * w, rcond=None)
        err = np.abs(basis @ c - d) * wb
        lawson *= err + 1e-12
        lawson /= lawson.max()
    taps = np.concatenate([c[half:0:-1], c[:half + 1]])
    return taps


def _remez_grid(num_taps: int, bands, desired, weights, grid_density: int):
    """Dense frequency grid over the union of bands with D(f), W(f)."""
    freqs, d, w = [], [], []
    for (lo, hi), dd, ww in zip(bands, desired, weights):
        npts = max(int((hi - lo) * 2 * grid_density * num_taps), 8)
        f = np.linspace(lo, hi, npts)
        freqs.append(f)
        d.append(np.full(npts, float(dd)))
        w.append(np.full(npts, float(ww)))
    return np.concatenate(freqs), np.concatenate(d), np.concatenate(w)


def _bary_weights(x: np.ndarray) -> np.ndarray:
    """Barycentric weights a_k = 1/prod_{j!=k}(x_k - x_j), computed in
    log space (sign tracked) so ~100-point extremal sets don't
    over/underflow float64."""
    diff = x[:, None] - x[None, :]
    np.fill_diagonal(diff, 1.0)
    sign = np.prod(np.sign(diff), axis=1)
    logs = np.sum(np.log(np.abs(diff)), axis=1)
    logs -= logs.mean()  # common scale cancels in every ratio we form
    return sign * np.exp(-logs)


def _remez_exchange(num_taps: int, bands, desired, weights,
                    grid_density: int = 16, max_iters: int = 40):
    """Parks-McClellan Remez exchange (filters/remez.rs re-design).

    Type-I (odd-length symmetric) linear-phase multiband design: the
    amplitude A(f) = sum_k c_k cos(2 pi f k) is the minimax weighted
    approximation of D(f), found by iterating the exchange: solve the
    alternation system on the current extremal set via barycentric
    Lagrange interpolation in x = cos(2 pi f), locate the new extrema of
    the weighted error on a dense grid, exchange, repeat until the
    ripple stops growing. Host-side float64 design code. Returns (taps,
    delta, extremal_freqs).
    """
    half = num_taps // 2
    n_ext = half + 2  # r+1 alternations for r = half+1 cosine coefficients
    f, d, wt = _remez_grid(num_taps, bands, desired, weights, grid_density)
    x = np.cos(2 * np.pi * f)
    # initial extremal set: spread evenly across the grid
    ext = np.round(np.linspace(0, len(f) - 1, n_ext)).astype(int)
    last_delta = 0.0
    signs = (-1.0) ** np.arange(n_ext)
    for _ in range(max_iters):
        xe, de, we = x[ext], d[ext], wt[ext]
        a = _bary_weights(xe)
        delta = float(np.sum(a * de) / np.sum(a * signs / we))
        ce = de - signs * delta / we  # A at the extremal points
        # barycentric interpolation of A on the full grid
        dx = x[:, None] - xe[None, :]
        hit = np.isclose(dx, 0.0, atol=1e-14)
        dx_safe = np.where(hit, 1.0, dx)
        num = np.sum(a * ce / dx_safe, axis=1)
        den = np.sum(a / dx_safe, axis=1)
        amp = num / den
        exact = hit.any(axis=1)
        if exact.any():
            amp[exact] = ce[hit[exact].argmax(axis=1)]
        err = wt * (amp - d)
        # candidate extrema: local maxima of |err| plus band edges
        abs_err = np.abs(err)
        cand = [0]
        cand += [i for i in range(1, len(f) - 1)
                 if abs_err[i] >= abs_err[i - 1] and abs_err[i] >= abs_err[i + 1]]
        cand.append(len(f) - 1)
        # band-edge grid indices (each band contributes its endpoints)
        edge = np.cumsum([0] + [max(int((hi - lo) * 2 * grid_density
                                        * num_taps), 8)
                                for lo, hi in bands])
        for e in edge[1:-1]:
            cand += [e - 1, e]
        cand = sorted(set(cand))
        # enforce sign alternation: among same-sign runs keep the largest
        kept: list[int] = []
        for i in cand:
            if kept and np.sign(err[i]) == np.sign(err[kept[-1]]):
                if abs_err[i] > abs_err[kept[-1]]:
                    kept[-1] = i
            else:
                kept.append(i)
        # trim to n_ext by dropping the weaker endpoint repeatedly
        while len(kept) > n_ext:
            if abs_err[kept[0]] < abs_err[kept[-1]]:
                kept.pop(0)
            else:
                kept.pop()
        if len(kept) < n_ext:  # degenerate grid — keep previous set
            break
        new_ext = np.asarray(kept, int)
        converged = (np.array_equal(new_ext, ext)
                     or abs(abs(delta) - last_delta) <= 1e-12
                     + 1e-6 * abs(delta))
        ext = new_ext
        last_delta = abs(delta)
        if converged:
            break
    # final solve on the settled extremal set, then reconstruct taps by
    # sampling A(f) at num_taps uniform frequencies (type-I IDFT)
    xe, de, we = x[ext], d[ext], wt[ext]
    a = _bary_weights(xe)
    delta = float(np.sum(a * de) / np.sum(a * signs / we))
    ce = de - signs * delta / we
    fu = np.arange(half + 1) / num_taps
    xu = np.cos(2 * np.pi * fu)
    dxu = xu[:, None] - xe[None, :]
    hitu = np.isclose(dxu, 0.0, atol=1e-14)
    dxu_safe = np.where(hitu, 1.0, dxu)
    au = (np.sum(a * ce / dxu_safe, axis=1)
          / np.sum(a / dxu_safe, axis=1))
    if hitu.any():
        rows = hitu.any(axis=1)
        au[rows] = ce[hitu[rows].argmax(axis=1)]
    n = np.arange(num_taps) - half
    # h[n] = (1/N) [A(0) + 2 sum_k A(k/N) cos(2 pi k n / N)]
    taps = (au[0] + 2.0 * np.sum(
        au[1:, None] * np.cos(2 * np.pi * np.arange(1, half + 1)[:, None]
                              * n[None, :] / num_taps), axis=0)) / num_taps
    return taps.astype(np.float64), abs(delta), f[ext]


def design_remez(num_taps: int, bands, desired, weights=None,
                 grid_density: int = 16) -> np.ndarray:
    """Parks-McClellan equiripple FIR design via Remez exchange
    (filters/remez.rs:design). Takes the IRLS solver only if the exchange
    degenerates (non-convergent extremal set)."""
    if num_taps % 2 == 0:
        raise ValueError("design_remez needs an odd tap count")
    bands = list(bands)
    desired = list(desired)
    if len(bands) != len(desired):
        raise ValueError("bands and desired must have equal length")
    w = list(weights) if weights is not None else [1.0] * len(bands)
    try:
        taps, _, _ = _remez_exchange(num_taps, bands, desired, w,
                                     grid_density)
        if not np.all(np.isfinite(taps)):
            raise FloatingPointError("non-finite taps")
        return taps
    except (FloatingPointError, np.linalg.LinAlgError, ZeroDivisionError):
        return design_equiripple(num_taps, bands, desired, w)
