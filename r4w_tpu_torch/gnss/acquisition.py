"""PCPS acquisition, batched over PRN × Doppler × code phase.

PyTorch counterpart of ``r4w_tpu.gnss.acquisition`` (a re-design of
waveform/gnss/acquisition.rs:104-199): the whole (PRN × Doppler) grid is
one batched computation,

    mixed[p, d, n]   = x[n]·e^{-j2πf_d t_n}           (outer product)
    CORR[p, d, :]    = IFFT( FFT(mixed) · conj(FFT(code_p)) )

with the transforms on cuFFT through ``torch.fft`` and the non-coherent
sum over code periods a loop that adds into one (P, S, D, F) float32
accumulator. Nothing here reaches a matmul or a convolution, so TF32
never applies: the correlations of the refine pass are elementwise
products summed over the last axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor


class AcquisitionResult(NamedTuple):
    prn: torch.Tensor  # (P,) PRN ids
    detected: torch.Tensor  # (P,) bool
    code_phase: torch.Tensor  # (P,) samples
    doppler_hz: torch.Tensor  # (P,)
    peak_metric: torch.Tensor  # (P,) peak/noise-floor
    cn0_estimate: torch.Tensor  # (P,) dB-Hz (valid where detected)


@dataclasses.dataclass(frozen=True)
class PcpsConfig:
    """Mirror of PcpsAcquisition settings (acquisition.rs:60-95)."""

    doppler_max_hz: float = 5000.0
    doppler_step_hz: float = 500.0
    threshold: float = 2.5
    coherent_periods: int = 1
    # Sub-sample replica phases: codes of shape (P, S, L), S replicas
    # gathered at sub-sample offsets (`sampled_code_bank`); the grid takes
    # the best sub-phase.
    subsample_phases: int = 4
    # The noise grid max follows max-of-gamma(K) statistics; with
    # auto_threshold the effective threshold is threshold plus
    # `noise_max_estimate` of the grid's size.
    auto_threshold: bool = True
    # "exact" = circular correlation at nfft = L (always correct); "pow2"
    # = two-period linear correlation at nfft = next_pow2(2L), K-1 slices
    # of 2L samples. "auto" resolves to "exact".
    fft_mode: str = "auto"
    # the PRN and Doppler axes are chunked so that the live correlation
    # tensor stays within this many bytes
    memory_budget_bytes: float = 4e9
    # Alignment verification pass: re-measure each PRN with windows
    # aligned to its code-period boundaries at the found code phase, so
    # secondary-code sign flips land on window edges. Needs >= 2 periods.
    align_refine: bool = True
    # carrier frequency for code-Doppler slewing in the refine pass
    carrier_hz: float = 1_575_420_000.0

    def noise_max_estimate(self, total_bins: int) -> float:
        """Mean-normalized (1-1/N) quantile of the max of N Gamma(K)
        noise bins, via the Wilson-Hilferty chi-square approximation."""
        k = max(1, self.coherent_periods)
        ln_n = float(np.log(max(total_bins, 2)))
        z = np.sqrt(2.0 * ln_n)  # ~ Phi^-1(1 - 1/N)
        wh = (1.0 - 1.0 / (9.0 * k) + z / (3.0 * np.sqrt(k))) ** 3
        return float(wh)


def doppler_bins(cfg: PcpsConfig) -> np.ndarray:
    n = int(2 * cfg.doppler_max_hz / cfg.doppler_step_hz) + 1
    return (-cfg.doppler_max_hz
            + np.arange(n) * cfg.doppler_step_hz).astype(np.float32)


def _doppler_tensor(cfg: PcpsConfig, device: torch.device) -> torch.Tensor:
    """`doppler_bins(cfg)` made on `device` (the same float64 arithmetic,
    then float32), with no copy from the host."""
    n = int(2 * cfg.doppler_max_hz / cfg.doppler_step_hz) + 1
    return (torch.arange(n, dtype=torch.float64, device=device) * cfg.doppler_step_hz
            - cfg.doppler_max_hz).to(REAL_DTYPE)


def _code_bank(codes, device: torch.device) -> torch.Tensor:
    """`codes` as a (P, S, L) float32 tensor on `device`."""
    codes = to_tensor(codes, REAL_DTYPE, device)
    return codes[:, None, :] if codes.dim() == 2 else codes


def pcps_grid(x, codes, sample_rate, cfg: PcpsConfig = PcpsConfig(),
              dop_subset=None) -> torch.Tensor:
    """Full correlation surface |corr|² of shape (P, D, L), on x's device.

    x: (N,) complex input; codes: (P, L) ±1 sampled replicas or a (P, S,
    L) sub-phase bank (L samples per code period, same rate as x).
    dop_subset: optional explicit Doppler bins (Hz) instead of the
    cfg-derived grid. With cfg.coherent_periods = K and N ≥ K·L, K period
    slices are correlated and their powers summed (non-coherent).

    The live correlation tensor is (P, S, D, F) complex64 per slice; the
    PRN axis, and for one PRN too large alone the Doppler axis, are
    chunked to cfg.memory_budget_bytes.
    """
    x = to_tensor(x, IQ_DTYPE)
    codes = _code_bank(codes, x.device)
    p, s, l = codes.shape
    if dop_subset is not None:
        return _pcps_grid_one(x, codes, sample_rate, cfg, dop_subset=dop_subset)
    n_dop = len(doppler_bins(cfg))
    k_eff = max(1, min(cfg.coherent_periods, x.shape[-1] // l))
    nfft_est = (1 << int(np.ceil(np.log2(2 * l)))
                if cfg.fft_mode == "pow2" and k_eff >= 2 else l)
    # per-PRN live bytes per slice: complex corr + f32 accumulator + slack
    per_prn = s * n_dop * nfft_est * 8 * 4
    budget = cfg.memory_budget_bytes
    if p * per_prn > budget:
        if per_prn <= budget:
            chunk = max(1, int(budget // per_prn))
            return torch.cat([_pcps_grid_one(x, codes[i: i + chunk], sample_rate, cfg)
                              for i in range(0, p, chunk)], dim=0)
        # one PRN alone exceeds the budget: also chunk the Doppler axis
        d_chunk = max(1, int(budget * n_dop // per_prn))
        dops = doppler_bins(cfg)
        outs = []
        for i in range(p):
            rows = [_pcps_grid_one(x, codes[i: i + 1], sample_rate, cfg,
                                   dop_subset=dops[j: j + d_chunk])
                    for j in range(0, n_dop, d_chunk)]
            outs.append(torch.cat(rows, dim=1))
        return torch.cat(outs, dim=0)
    return _pcps_grid_one(x, codes, sample_rate, cfg)


def _pcps_grid_one(x: torch.Tensor, codes: torch.Tensor, sample_rate, cfg: PcpsConfig,
                   dop_subset=None) -> torch.Tensor:
    p, s, l = codes.shape
    device = x.device
    k = max(1, min(cfg.coherent_periods, x.shape[-1] // l))
    mode = "exact" if cfg.fft_mode == "auto" else cfg.fft_mode
    if mode == "pow2" and k >= 2:
        # slice i covers samples [i·L, i·L + 2L); with nfft >= 2L and the
        # code zero-padded, every lag in [0, L) is a full L-term sum
        nfft = 1 << int(np.ceil(np.log2(2 * l)))
        xs = x[..., : k * l].unfold(-1, 2 * l, l)  # (K-1, 2L)
        t = torch.arange(2 * l, dtype=REAL_DTYPE, device=device) / real_scalar(sample_rate, device)
    else:
        # exact-length FFT: the code is L-periodic, so circular correlation
        # at period L is the correct operation
        nfft = l
        xs = x[..., : k * l].reshape(k, l)
        t = torch.arange(l, dtype=REAL_DTYPE, device=device) / real_scalar(sample_rate, device)
    dops = (_doppler_tensor(cfg, device) if dop_subset is None
            else torch.as_tensor(dop_subset, dtype=REAL_DTYPE, device=device))
    # carrier wipeoff for every Doppler bin at once; a slice's start phase
    # only rotates its correlation, which |·|² discards
    carriers = cis((-2 * math.pi) * (dops[:, None] * t[None, :]))
    code_fft = torch.conj(torch.fft.fft(codes.to(IQ_DTYPE), n=nfft, dim=-1))  # (P, S, F)
    acc = torch.zeros((p, s, dops.shape[0], nfft), dtype=REAL_DTYPE, device=device)
    for x_slice in xs:
        mixed = x_slice[None, :] * carriers  # (D, W)
        mf = torch.fft.fft(mixed, n=nfft, dim=-1)  # (D, F)
        corr = torch.fft.ifft(mf[None, None, :, :] * code_fft[:, :, None, :], dim=-1)
        acc += corr.real ** 2 + corr.imag ** 2
    power = torch.amax(acc, dim=1)  # best sub-phase replica: (P, D, F)
    return power[..., :l]


def _aligned_metric(x: torch.Tensor, codes: torch.Tensor, phase: torch.Tensor,
                    dop: torch.Tensor, noise_floor: torch.Tensor, sample_rate,
                    cfg: PcpsConfig) -> torch.Tensor:
    """Verification statistic with code-period-aligned windows: for each
    PRN, segments of one code period starting at its found code phase are
    coherently correlated at the found Doppler (±half a bin) and
    power-summed, over code phase offsets of ±2 samples at sub-phase
    granularity. Each window takes its integer start from floor(k·drift)
    and its replica from the sub-phase bank entry nearest the residual,
    so the code-Doppler slew stays aligned over long integrations."""
    p, s, l = codes.shape
    n = x.shape[-1]
    device = x.device
    k_ref = max(1, min(cfg.coherent_periods, n // l) - 1)
    t = torch.arange(l, dtype=REAL_DTYPE, device=device) / real_scalar(sample_rate, device)
    ks = torch.arange(k_ref, dtype=REAL_DTYPE, device=device)
    base = (phase.to(torch.int64)[:, None, None]
            + (torch.arange(k_ref, device=device) * l)[None, :, None]
            + torch.arange(l, device=device)[None, None, :])  # (P, K, L)
    rows = torch.arange(p, device=device)[:, None]
    best = torch.zeros((p,), dtype=REAL_DTYPE, device=device)
    taus = np.arange(-2.0, 2.0 + 1e-9, 1.0 / s)
    for ddop in (-0.5, 0.0, 0.5):
        fd = dop + ddop * cfg.doppler_step_hz  # (P,)
        drift = -fd / real_scalar(cfg.carrier_hz, device) * l  # samples gained per period
        carrier = cis((-2 * math.pi) * fd[:, None] * t[None, :])  # (P, L)
        for dtau in taus:
            # the k·L term stays out of the float math (in `base`): only the
            # small slew is float32, so its fraction selects the sub-phase
            slew = float(dtau) + ks[None, :] * drift[:, None]  # (P, K)
            i0 = torch.floor(slew)
            sub_raw = torch.round((slew - i0) * s).to(torch.int32)
            i0 = i0.to(torch.int32) + torch.div(sub_raw, s, rounding_mode="floor")
            # signal delayed by frac ↔ replica bank entry advanced by s/S,
            # so the matching sub-phase is the negated residual
            sub = torch.remainder(-sub_raw, s)  # (P, K)
            idx = (base + i0[:, :, None]).clamp(0, n - 1)
            mixed = x[idx] * carrier[:, None, :]  # (P, K, L)
            code_k = codes[rows, sub]  # (P, K, L)
            corr_r = (mixed.real * code_k).sum(-1)
            corr_i = (mixed.imag * code_k).sum(-1)
            pw = torch.sum(corr_r ** 2 + corr_i ** 2, dim=-1)  # (P,)
            best = torch.maximum(best, pw)
    k_grid = max(1, min(cfg.coherent_periods, n // l))
    return best / torch.clamp(noise_floor * k_ref / k_grid, min=1e-30)


def acquire(x, codes, prns, sample_rate, cfg: PcpsConfig = PcpsConfig()
            ) -> AcquisitionResult:
    """Batched PCPS for all PRNs at once (acquisition.rs:104 `acquire`),
    on x's device (numpy input goes to the default device)."""
    x = to_tensor(x, IQ_DTYPE)
    codes = _code_bank(codes, x.device)
    n_subphases = codes.shape[1]
    power = pcps_grid(x, codes, sample_rate, cfg)  # (P, D, L)
    p, d, l = power.shape
    flat = power.reshape(p, -1)
    peak = torch.amax(flat, dim=-1)
    arg = torch.argmax(flat, dim=-1)  # the first maximum, as jnp.argmax
    dop_idx = torch.div(arg, l, rounding_mode="floor")
    phase = torch.remainder(arg, l)
    noise_floor = (torch.sum(flat, dim=-1) - peak) / (d * l - 1)
    metric = peak / torch.clamp(noise_floor, min=1e-30)
    dops = _doppler_tensor(cfg, x.device)
    if cfg.align_refine and x.shape[-1] >= 2 * l:
        refined = _aligned_metric(x, codes, phase, dops[dop_idx], noise_floor,
                                  sample_rate, cfg)
        metric = torch.maximum(metric, refined)
    eff_threshold = cfg.threshold + (
        cfg.noise_max_estimate(d * l * n_subphases) if cfg.auto_threshold else 0.0)
    detected = metric > eff_threshold
    code_period = l / sample_rate
    cn0 = 10.0 * torch.log10(torch.clamp(metric / code_period, min=1e-12))
    return AcquisitionResult(
        prn=torch.as_tensor(np.asarray(prns), dtype=torch.int32, device=x.device),
        detected=detected,
        code_phase=phase.to(REAL_DTYPE),
        doppler_hz=dops[dop_idx],
        peak_metric=metric.to(REAL_DTYPE),
        cn0_estimate=cn0.to(REAL_DTYPE),
    )


def sampled_code_bank(waveforms, waveform_rate, sample_rate, n_samples,
                      n_subphases: int = 4) -> np.ndarray:
    """(P, S, L) replica bank: each PRN's spread waveform nearest-sampled
    at S sub-sample phase offsets — matching how a delayed signal is
    actually gathered, which a band-limited fractional shift cannot
    (nearest-neighbour sampling of a non-band-limited BOC waveform).

    waveforms: sequence of per-PRN spread chip waveforms (±1-ish arrays at
    waveform_rate, e.g. CBOC sub-chips at 12.276 MHz).
    """
    out = []
    ratio = waveform_rate / sample_rate
    n = np.arange(n_samples)
    for w in waveforms:
        lw = len(w)
        rows = []
        for sp in range(n_subphases):
            idx = np.floor((n + sp / n_subphases) * ratio).astype(np.int64) % lw
            rows.append(w[idx])
        out.append(np.stack(rows))
    return np.stack(out).astype(np.float32)
