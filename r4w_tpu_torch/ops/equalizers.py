"""Equalizers: LMS, RLS, CMA, DFE, MMSE/ZF block equalizers, the
time-domain equalizer, turbo equalization and MLSE.

PyTorch counterpart of ``r4w_tpu.ops.equalizers`` (equalizer.rs,
cma_equalizer.rs, lms_filter.rs, adaptive_filter_rls.rs,
decision_feedback_equalizer.rs, mmse_equalizer.rs,
frequency_domain_equalizer.rs, time_domain_equalizer.rs,
turbo_equalizer.rs, sequential_detection_mlse.rs). The adaptive
equalizers are step loops over the symbols whose taps stay tensors on the
symbols' device, one step vectorised over the taps; the block equalizers
are closed-form (the MMSE solve on the host in float64, as the
reference's). `mlse_equalize` is an add-compare-select loop over time
vectorised over the M^(L-1) states and a reverse traceback, the same
pattern as the reference's scans; its branch metrics use the reference's
complex magnitude (`core.hostio.complex_abs`), so its metrics and decisions are the
reference's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import complex_abs, rounded_sum
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE, to_tensor


class EqOut(NamedTuple):
    y: torch.Tensor      # equalized symbols
    error: torch.Tensor  # per-step error magnitude
    taps: torch.Tensor   # final taps


def _windows(x: torch.Tensor, n_taps: int) -> torch.Tensor:
    """(..., N, taps) sliding windows, newest-first, zero history."""
    pad = torch.nn.functional.pad(x, (n_taps - 1, 0))
    return pad.unfold(-1, n_taps, 1).flip(-1)


def _unit(n: int, at: int, device) -> torch.Tensor:
    w = torch.zeros(n, dtype=IQ_DTYPE, device=device)
    w[at] = 1.0
    return w


def _stack(ys: list, errs: list, x: torch.Tensor):
    """(outputs, |errors|) of a loop: the magnitudes taken once, after it."""
    if not ys:
        return x.new_zeros(0), torch.zeros(0, dtype=REAL_DTYPE, device=x.device)
    return torch.stack(ys), complex_abs(torch.stack(errs))


def lms_equalize(x, desired, n_taps: int = 11, mu: float = 0.01,
                 taps0=None) -> EqOut:
    """Data-aided LMS: w += μ·e*·u (lms_filter.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    u = _windows(x, n_taps)
    d = to_tensor(desired, IQ_DTYPE, x.device)
    w = (to_tensor(taps0, IQ_DTYPE, x.device) if taps0 is not None
         else _unit(n_taps, 0, x.device))
    ys, errs = [], []
    for t in range(u.shape[0]):
        un = u[t]
        y = torch.sum(w * un)
        e = d[t] - y
        w = w + mu * e * torch.conj(un)
        ys.append(y)
        errs.append(e)
    return EqOut(*_stack(ys, errs, x), w)


def rls_equalize(x, desired, n_taps: int = 11, lam: float = 0.99,
                 delta: float = 0.01) -> EqOut:
    """Recursive least squares (adaptive_filter_rls.rs). The P update's
    products are elementwise sums (no matmul, so no TF32 on the card)."""
    x = to_tensor(x, IQ_DTYPE)
    u = _windows(x, n_taps)
    d = to_tensor(desired, IQ_DTYPE, x.device)
    w = torch.zeros(n_taps, dtype=IQ_DTYPE, device=x.device)
    p = torch.eye(n_taps, dtype=IQ_DTYPE, device=x.device) / delta
    ys, errs = [], []
    for t in range(u.shape[0]):
        un = u[t]
        pu = torch.sum(p * torch.conj(un), dim=-1)  # P @ conj(u)
        k = pu / (lam + torch.real(torch.sum(un * pu)) + 0j)
        y = torch.sum(w * un)
        e = d[t] - y
        w = w + k * e
        p = (p - k[:, None] * torch.sum(un[:, None] * p, dim=0)[None, :]) / lam
        ys.append(y)
        errs.append(e)
    return EqOut(*_stack(ys, errs, x), w)


def cma_equalize(x, n_taps: int = 11, mu: float = 0.001,
                 modulus: float = 1.0, taps0=None) -> EqOut:
    """Constant-modulus blind equalizer (cma_equalizer.rs):
    e = y·(R2 − |y|²), w += μ·e*·u."""
    x = to_tensor(x, IQ_DTYPE)
    u = _windows(x, n_taps)
    w = (to_tensor(taps0, IQ_DTYPE, x.device) if taps0 is not None
         else _unit(n_taps, n_taps // 2, x.device))
    r2 = modulus ** 2
    ys, errs = [], []
    for t in range(u.shape[0]):
        un = u[t]
        y = torch.sum(w * un)
        e = y * (r2 - (y.real ** 2 + y.imag ** 2))
        w = w + mu * e * torch.conj(un)
        ys.append(y)
        errs.append(e)
    return EqOut(*_stack(ys, errs, x), w)


def _nearest(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The constellation point nearest each y (the first on ties)."""
    d = y[..., None] - c
    return torch.take(c, torch.argmin(d.real ** 2 + d.imag ** 2, dim=-1))


class _DfeStep:
    """One DFE step on the taps w and inputs x, both (2, n) complex64: row 0
    the feed-forward taps and samples, row 1 the feedback taps and past
    decisions, zero-padded at the front to a common n (zero terms are
    exact no-ops). Calling it returns (y, the decision, e, the taps'
    update).

    The arithmetic is the reference's compiled step's, rounding for
    rounding: each product's real part a·c − b·d is a fused multiply-add
    added to the running real sum; the imaginary sum nests two
    (fma(b, c, fma(a, d, acc))); the slicer's |y − p|² and the update's
    μe·conj(x) are fused the same way. Fused multiply-adds are float64
    sums of exact products rounded once (`core.hostio.rounded_sum`), so a
    step is bit for bit the reference's on any device (a decision-directed
    loop amplifies any difference into other decisions). The float64
    operands of the two sums a term live in buffers made once."""

    def __init__(self, n: int, const: torch.Tensor, mu: float):
        dev = const.device
        self.const, self.mu = const, mu
        self.first = torch.empty((2, n, 2), dtype=torch.float64, device=dev)
        self.second = torch.zeros((2, n, 2), dtype=torch.float64, device=dev)
        self.second[..., 0] = -0.0  # -0 + s = s: the real sum takes one add a term
        self.acc = torch.zeros((2, 2, 2), dtype=REAL_DTYPE, device=dev)  # two buffers in turn
        self.sign = torch.tensor([1.0, -1.0], dtype=REAL_DTYPE, device=dev)

    def __call__(self, w: torch.Tensor, x: torch.Tensor):
        w32, x32 = torch.view_as_real(w), torch.view_as_real(x)
        w64, x64 = w32.double(), x32.double()
        a, b, c, d = w64[..., 0], w64[..., 1], x64[..., 0], x64[..., 1]
        real = torch.sub(a * c, w32[..., 1] * x32[..., 1])  # a·c − fl(b·d), in float64
        self.first[..., 0].copy_(real.to(REAL_DTYPE))  # rounded once: the fused real part
        torch.mul(a, d, out=self.first[..., 1])
        torch.mul(b, c, out=self.second[..., 1])
        acc = self.acc
        acc.zero_()
        for f, g in zip(self.first.unbind(1), self.second.unbind(1)):  # term by term
            rounded_sum(f, acc[0], out=acc[1])
            rounded_sum(g, acc[1], out=acc[0])
        y = torch.view_as_complex(acc[0, 0] - acc[0, 1])
        diff = torch.view_as_real(y - self.const)  # (M, 2)
        sq = diff.double().square()
        dec = torch.take(self.const, torch.argmin(rounded_sum(sq[:, 0], diff[:, 1] * diff[:, 1])))
        e = dec - y
        m32 = torch.view_as_real(e * self.mu)  # (μ·re, μ·im), each one rounding
        # μe·conj(x): (c·mr + fl(xi·mi), c·mi − fl(xi·mr)), each rounded once
        small = x32[..., 1:] * m32.flip(-1) * self.sign
        upd = rounded_sum(c[..., None] * m32.double(), small)
        return y, dec, e, torch.view_as_complex(upd)


def dfe_equalize(x, n_ff: int = 7, n_fb: int = 3, mu: float = 0.01,
                 constellation=None) -> EqOut:
    """Decision-feedback equalizer (decision_feedback_equalizer.rs):
    feed-forward on received samples, feedback on past decisions. A step
    loop whose arithmetic is the reference's, rounding for rounding
    (`_DfeStep`)."""
    x = to_tensor(x, IQ_DTYPE)
    dev = x.device
    const = to_tensor(constellation if constellation is not None else [1.0 + 0j, -1.0 + 0j],
                      IQ_DTYPE, dev)
    n = max(n_ff, n_fb)
    u = torch.nn.functional.pad(_windows(x, n_ff), (n - n_ff, 0))
    w = torch.zeros((2, n), dtype=IQ_DTYPE, device=dev)
    w[0, n - n_ff] = 1.0
    past = torch.zeros(n, dtype=IQ_DTYPE, device=dev)
    sign = torch.tensor([[1.0], [-1.0]], dtype=REAL_DTYPE, device=dev)  # ff += , fb -=
    step = _DfeStep(n, const, float(np.float32(mu)))
    ys, errs = [], []
    for t in range(u.shape[0]):
        y, dec, e, upd = step(w, torch.stack([u[t], past]))
        w = w + upd * sign
        past = torch.cat([past[:n - n_fb], dec.view(1), past[n - n_fb:n - 1]])
        ys.append(y)
        errs.append(e)
    return EqOut(*_stack(ys, errs, x), torch.cat([w[0, n - n_ff:], w[1, n - n_fb:]]))


def mmse_block_equalize(rx, channel_taps, snr_db: float = 20.0,
                        n_taps: int = 15, delay: int | None = None):
    """Closed-form MMSE linear equalizer for a known channel
    (mmse_equalizer.rs): w = (H^H H + I/γ)^-1 H^H e_d, solved on the host
    in float64."""
    h = np.asarray(channel_taps.cpu() if isinstance(channel_taps, torch.Tensor)
                   else channel_taps, np.complex128)
    lh = len(h)
    n = n_taps
    delay = delay if delay is not None else (n + lh) // 2
    # convolution matrix H: (n + lh - 1, n)
    hm = np.zeros((n + lh - 1, n), np.complex128)
    for i in range(n):
        hm[i : i + lh, i] = h
    gamma = 10.0 ** (snr_db / 10.0)
    r = hm.conj().T @ hm + np.eye(n) / gamma
    e_d = np.zeros(n + lh - 1, np.complex128)
    e_d[delay] = 1.0
    w = np.linalg.solve(r, hm.conj().T @ e_d)
    rx = to_tensor(rx, IQ_DTYPE)
    w_t = torch.from_numpy(w.astype(np.complex64)).to(rx.device)
    # causal FIR: y[n] = Σ_j w[j]·rx[n-j]; output lags syms by `delay`
    y = torch.sum(_windows(rx, n) * w_t, dim=-1)
    return y, w_t


def fde_equalize(rx_blocks, channel_freq, snr_db: float = 20.0):
    """Frequency-domain MMSE equalizer (frequency_domain_equalizer.rs):
    per-bin W = H*/(|H|² + 1/γ), applied to FFT blocks."""
    rx = to_tensor(rx_blocks, IQ_DTYPE)
    h = to_tensor(channel_freq, IQ_DTYPE, rx.device)
    gamma = 10.0 ** (snr_db / 10.0)
    w = torch.conj(h) / (h.real ** 2 + h.imag ** 2 + 1.0 / gamma)
    return torch.fft.ifft(torch.fft.fft(rx, dim=-1) * w, dim=-1)


# --------------------------------------------------------------------------
# Time-domain adaptive equalizer with train / decision-directed modes
# --------------------------------------------------------------------------


def nearest_point(y, constellation):
    """Slice (...,) symbols to the nearest constellation point
    (time_domain_equalizer.rs:126 nearest_qam_point); the first on ties."""
    y = to_tensor(y, IQ_DTYPE)
    return _nearest(y, to_tensor(constellation, IQ_DTYPE, y.device))


def time_domain_equalizer(x, n_taps: int = 11, algorithm: str = "lms",
                          mu: float = 0.01, lam: float = 0.99,
                          reference=None, constellation=None,
                          train_len: int | None = None) -> EqOut:
    """Adaptive FIR equalizer over time samples with an optional training
    phase followed by decision-directed adaptation
    (time_domain_equalizer.rs:149 TimeDomainEqualizer: Training /
    DecisionDirected modes, LMS/NLMS/RLS algorithms).

    x: (N,) received symbols. reference: known symbols for training
    (length defines the training span unless train_len is given).
    constellation: slicer points for the decision-directed phase; when
    None, adaptation stops after training (weights frozen).
    """
    x = to_tensor(x, IQ_DTYPE)
    wins = _windows(x, n_taps)  # (N, K) newest-first
    if reference is not None:
        ref = to_tensor(reference, IQ_DTYPE, x.device)
        t_len = int(train_len if train_len is not None else ref.shape[-1])
        if algorithm == "rls":
            trained = rls_equalize(x[:t_len], ref[:t_len], n_taps, lam)
        else:
            trained = lms_equalize(x[:t_len], ref[:t_len], n_taps, mu)
        w = trained.taps
        train_y, train_err = trained.y, trained.error
    else:
        t_len = 0
        w = _unit(n_taps, n_taps // 2, x.device)
        train_y = x.new_zeros(0)
        train_err = torch.zeros(0, dtype=REAL_DTYPE, device=x.device)

    rest = wins[t_len:]
    if constellation is None:
        y2 = torch.sum(rest * w, dim=-1)
        err2 = torch.zeros(y2.shape, dtype=REAL_DTYPE, device=x.device)
    else:
        c = to_tensor(constellation, IQ_DTYPE, x.device)
        ys, errs = [], []
        for t in range(rest.shape[0]):
            u = rest[t]
            y = torch.sum(w * u)
            e = _nearest(y, c) - y
            if algorithm == "nlms":
                norm = torch.sum(u.real ** 2 + u.imag ** 2) + 1e-12
                w = w + mu / norm * e * torch.conj(u)
            else:
                w = w + mu * e * torch.conj(u)
            ys.append(y)
            errs.append(e)
        y2, err2 = _stack(ys, errs, x)
    return EqOut(y=torch.cat([train_y, y2]), error=torch.cat([train_err, err2]), taps=w)


# --------------------------------------------------------------------------
# Turbo equalizer: frequency-domain soft-IC MMSE + max-log BCJR
# --------------------------------------------------------------------------


def turbo_equalizer_tx(bits, interleaver=None, device=None):
    """Encode info bits for the turbo-equalized link: rate-1/2 RSC
    (systematic + parity multiplexed), interleaved, BPSK-mapped.

    Returns (x (2N,) complex BPSK on `device`, coded (2N,) bits, pi (2N,)).
    """
    from r4w_tpu_torch.fec.turbo import default_interleaver, rsc_encode

    bits = np.asarray(bits.cpu() if isinstance(bits, torch.Tensor) else bits, np.int32)
    par, _ = rsc_encode(bits)
    coded = np.empty(2 * len(bits), np.int32)
    coded[0::2] = bits
    coded[1::2] = par
    pi = (np.asarray(interleaver, np.int64) if interleaver is not None
          else default_interleaver(len(coded), seed=11))
    x = (1.0 - 2.0 * coded[pi]).astype(np.complex64)
    return to_tensor(x, device=device), coded, pi


def turbo_equalize(rx, channel_taps, interleaver, noise_var,
                   n_iters: int = 4):
    """Iterative (turbo) equalization of a BPSK RSC-coded burst over a
    known ISI channel (turbo_equalizer.rs:103 TurboEqualizer with
    EqualizerType::MmseLinear + convolutional decoder).

    Per iteration: frequency-domain soft-interference-cancellation MMSE
    (priors → symbol means/variances → extrinsic symbol LLRs), then a
    max-log BCJR over the RSC trellis whose systematic extrinsic feeds
    the next equalization pass. Parity positions re-enter with zero
    prior — the standard simplification.

    rx: (M,) received burst (M = 2·n_info; the FD model is circular).
    Returns (hard_info_bits, posterior LLRs).
    """
    from r4w_tpu_torch.fec.turbo import _bcjr_maxlog

    rx = to_tensor(rx, IQ_DTYPE)
    dev = rx.device
    m = rx.shape[-1]
    pi = torch.as_tensor(np.asarray(interleaver, np.int64), device=dev)
    inv = torch.empty_like(pi)
    inv[pi] = torch.arange(m, device=dev)
    h_f = torch.fft.fft(to_tensor(channel_taps, IQ_DTYPE, dev), n=m)
    h2 = h_f.real ** 2 + h_f.imag ** 2
    rx_f = torch.fft.fft(rx)
    sigma2 = to_tensor(noise_var, REAL_DTYPE, dev)

    la = torch.zeros(m, dtype=REAL_DTYPE, device=dev)  # prior LLRs on interleaved coded bits
    ext_sys = llr_sys = None
    for _ in range(n_iters):
        # prior symbol statistics (BPSK: mean = tanh(La/2), var = 1-mean²)
        xbar = torch.tanh(torch.clamp(la, -30.0, 30.0) / 2.0).to(IQ_DTYPE)
        vbar = torch.mean(1.0 - xbar.real ** 2)
        # FD soft-IC MMSE: x̂ = x̄ + F⁻¹[ H*/(|H|²v̄+σ²) · (RX − H·X̄) ]
        denom = h2 * vbar + sigma2
        resid_f = rx_f - h_f * torch.fft.fft(xbar)
        xhat = xbar + torch.fft.ifft(torch.conj(h_f) / denom * resid_f)
        mu_eq = torch.mean(h2 / denom)
        # extrinsic symbol LLR (bit 0 ↔ +1): Le = 2·Re{x̂}/(1−μ·v̄)
        le = 2.0 * xhat.real / torch.clamp_min(1.0 - mu_eq * vbar, 1e-6)
        le_coded = le[inv]  # deinterleave to coded order
        llr_sys = le_coded[0::2]
        llr_par = le_coded[1::2]
        ext_sys = _bcjr_maxlog(llr_sys, llr_par, torch.zeros_like(llr_sys))
        la_coded = torch.zeros(m, dtype=REAL_DTYPE, device=dev)
        la_coded[0::2] = ext_sys
        la = la_coded[pi]
    post = llr_sys + ext_sys
    return (post < 0).to(SYMBOL_DTYPE), post


# --------------------------------------------------------------------------
# MLSE
# --------------------------------------------------------------------------


def _mlse_trellis(h: np.ndarray, con: np.ndarray):
    """(emit (S, M) complex64, prev_state (S, M), prev_sym (S, M)) of the ISI
    trellis: a state holds the last L-1 symbols, newest in the low digit."""
    m = len(con)
    l = len(h)
    n_states = m ** (l - 1) if l > 1 else 1
    emit = np.zeros((n_states, m), np.complex64)
    next_state = np.zeros((n_states, m), np.int32)
    for s in range(n_states):
        digits = []
        tmp = s
        for _ in range(l - 1):
            digits.append(tmp % m)  # digits[k] = symbol at delay k+1
            tmp //= m
        for a in range(m):
            acc = h[0] * con[a]
            for k, d in enumerate(digits):
                acc += h[k + 1] * con[d]
            emit[s, a] = acc
            next_state[s, a] = (s * m + a) % n_states if l > 1 else 0
    # predecessor table: states whose next is s', and the input symbol
    prev_state = np.zeros((n_states, m), np.int32)
    prev_sym = np.zeros((n_states, m), np.int32)
    fill: list[list] = [[] for _ in range(n_states)]
    for s in range(n_states):
        for a in range(m):
            fill[next_state[s, a]].append((s, a))
    for sp in range(n_states):
        for j, (s, a) in enumerate(fill[sp]):
            prev_state[sp, j] = s
            prev_sym[sp, j] = a
    return emit, prev_state, prev_sym


def mlse_equalize(y, channel_taps, constellation):
    """Maximum-likelihood sequence estimation over the ISI trellis
    (sequential_detection_mlse.rs role): Viterbi with M^(L-1) states
    where L = len(channel_taps), branch metric
    |y[n] − Σ_k h[k]·s[n−k]|².

    y: (..., N) received symbols (symbol-spaced); channel_taps: (L,)
    complex (h[0] = cursor); constellation: (M,) points. Returns
    decided constellation indices (..., N) int32. State count M^(L-1)
    must stay small (QPSK, L≤5 → ≤256 states).

    An add-compare-select step a symbol, vectorised over the states
    through the predecessor table (the first predecessor on ties), the
    decisions kept as int8 on the device, then a reverse traceback from
    the best final state.
    """
    y = to_tensor(y, IQ_DTYPE)
    dev = y.device
    h = np.asarray(channel_taps.cpu() if isinstance(channel_taps, torch.Tensor)
                   else channel_taps, np.complex64)
    con = np.asarray(constellation.cpu() if isinstance(constellation, torch.Tensor)
                     else constellation, np.complex64)
    m = len(con)
    n_states = m ** (len(h) - 1) if len(h) > 1 else 1
    if n_states * m > 65536:
        raise ValueError(f"MLSE trellis too large: {n_states}x{m}")
    emit, prev_state, prev_sym = _mlse_trellis(h, con)
    prev_flat = torch.from_numpy((prev_state.astype(np.int64) * m + prev_sym).reshape(-1)).to(dev)
    prev_state_t = torch.from_numpy(prev_state.astype(np.int64)).to(dev)
    prev_sym_t = torch.from_numpy(prev_sym).to(dev)
    emit_t = torch.from_numpy(emit).to(dev)

    lead, n = y.shape[:-1], y.shape[-1]
    if n == 0:
        return torch.zeros(lead + (0,), dtype=SYMBOL_DTYPE, device=dev)
    # every step's branch metrics at once, |y_t − emit[s, a]|², gathered into
    # each target's predecessor order: (N, ..., S', M)
    bm = complex_abs(y.movedim(-1, 0)[..., None, None] - emit_t) ** 2
    bm_into = bm.reshape(bm.shape[:-2] + (n_states * m,)).index_select(-1, prev_flat)
    bm_into = bm_into.reshape(bm.shape)
    prev_index = prev_state_t.reshape(-1)
    metrics = torch.zeros(lead + (n_states,), dtype=REAL_DTYPE, device=dev)
    decisions = []
    for t in range(n):
        cand = metrics.index_select(-1, prev_index).reshape(bm.shape[1:]) + bm_into[t]
        new, best = torch.min(cand, dim=-1)
        metrics = new - torch.amin(new, dim=-1, keepdim=True)
        decisions.append(best.to(torch.int8))
    decisions = torch.stack(decisions)  # (N, ..., S')

    state = torch.argmin(metrics, dim=-1)
    prev_sym_flat = prev_sym_t.reshape(-1)
    syms = []
    for t in range(n - 1, -1, -1):
        j = torch.gather(decisions[t], -1, state[..., None])[..., 0]
        flat = state * m + j
        syms.append(torch.take(prev_sym_flat, flat))
        state = torch.take(prev_index, flat)
    return torch.stack(syms[::-1], dim=-1).to(SYMBOL_DTYPE)
