"""LoRa synchronisation: preamble detection, CFO estimation, frame alignment.

PyTorch counterpart of ``r4w_tpu.waveforms.lora.sync``. Every candidate
symbol window at a stride of N/4 is dechirped and transformed at once;
runs of strong windows that agree on their peak bin one symbol apart mark
the upchirp preamble, and the SFD downchirp, dechirped with the upchirp,
separates CFO from timing. The windows are `unfold` views of the capture,
and both products go through `kernels.dechirp.dechirp_power_dispatch`: the
Hopper kernel on a CUDA tensor, its plain version on a CPU tensor. At
oversample > 1 the windows and the chirp are decimated before the product,
which equals the reference's (x·d)[::osf] element for element. Where the
reference takes an argmax of powers, the port takes the first within
TIE_REL of the highest (`first_peak`): powers tied but for float32
rounding otherwise let the transform's rounding choose, and the kernel
and the plain FFT round differently. `detect_preamble` keeps its results on the samples' device; `synchronize`
reads `detected` and `payload_start` on the host, as the reference does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from r4w_tpu_torch.core.fftops import find_peak_interpolated
from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.kernels.dechirp import dechirp_power_dispatch
from r4w_tpu_torch.waveforms.lora import chirp as chirp_mod
from r4w_tpu_torch.waveforms.lora.params import LoRaParams

PER_SYMBOL = 4  # windows per symbol at the N/4 stride
TIE_REL = 1e-5  # powers this close are equal but for float32 rounding


class SyncResult(NamedTuple):
    detected: torch.Tensor       # bool
    frame_start: torch.Tensor    # sample index where the preamble begins
    payload_start: torch.Tensor  # sample index of the first payload symbol
    cfo_hz: torch.Tensor         # carrier frequency offset estimate
    preamble_peak_bin: torch.Tensor


def _dechirp_rows(params: LoRaParams, rows: torch.Tensor, chirp: torch.Tensor) -> torch.Tensor:
    """|FFT(rows·chirp)|² of (R, N) sample rows, decimated to K chips first."""
    osf = params.oversample
    if osf > 1:
        rows, chirp = rows[..., ::osf], chirp[::osf]
    return dechirp_power_dispatch(rows, chirp)


def dechirp_windows(params: LoRaParams, samples, stride: int | None = None):
    """|FFT(window·downchirp)|² for every candidate window of a 1-D capture.

    Returns (power (W, K) float32, starts (W,) int64).
    """
    n = params.samples_per_symbol
    stride = stride or n // 4
    x = to_tensor(samples, IQ_DTYPE)
    n_win = max((x.shape[-1] - n) // stride + 1, 0)
    starts = torch.arange(n_win, device=x.device) * stride
    if n_win == 0:
        k = params.chips_per_symbol
        return torch.zeros((0, k), dtype=REAL_DTYPE, device=x.device), starts
    wins = x.unfold(-1, n, stride)  # (W, N) view
    return _dechirp_rows(params, wins, chirp_mod.base_downchirp(params, x.device)), starts


def preamble_candidates(power: torch.Tensor, min_symbols: int = 4, threshold: float = 8.0):
    """(detected, candidates, peak, bin) of the run test on dechirped
    windows (W, K); peak and bin are each window's (bin: `first_peak`).

    A window is strong when its peak exceeds `threshold` times its mean;
    it starts a run when it and the windows 1..min_symbols-1 symbols later
    (4 windows a symbol, wrapping around the end) are strong on one bin.
    The candidates are the first run's window and the three after it
    (clipped to the last window); without a run, windows 0-3.
    """
    peak = torch.amax(power, dim=-1)
    bins = first_peak(power)
    strong = peak > threshold * torch.clamp_min(torch.mean(power, dim=-1), 1e-30)
    w = power.shape[0]
    runs = torch.ones(w, dtype=torch.bool, device=power.device)
    for m in range(1, min_symbols):
        shift = -PER_SYMBOL * m
        runs = runs & torch.roll(strong, shift) & (torch.roll(bins, shift) == bins)
    runs = runs & strong
    first = torch.argmax(runs.to(torch.int32))  # the first maximum; 0 when none
    cand = torch.clamp(first + torch.arange(PER_SYMBOL, device=power.device), 0, w - 1)
    return torch.any(runs), cand, peak, bins


def _near_top(power: torch.Tensor) -> torch.Tensor:
    """Which entries of `power` lie within TIE_REL of the last axis' highest."""
    return power >= torch.amax(power, dim=-1, keepdim=True) * (1.0 - TIE_REL)


def first_peak(power: torch.Tensor) -> torch.Tensor:
    """The index along the last axis of the first entry within TIE_REL of
    the highest. A tone between two bins (at oversample 2 a half-chip
    timing offset) or windows wholly inside the preamble give peaks equal
    but for float32 rounding: an argmax among them, the reference's
    choice, is the transform's rounding, and differs between the kernel
    and the plain FFT. The first of them does not."""
    return torch.argmax(_near_top(power).to(torch.int32), dim=-1)


def candidates_tied(power: torch.Tensor) -> bool:
    """Whether two distinct candidate windows of a detected preamble peak
    within TIE_REL of each other in dechirped windows (W, K)."""
    detected, cand, peak, _ = preamble_candidates(power)
    return bool(detected) and int(_near_top(peak[torch.unique(cand)]).sum()) > 1


def detect_preamble(params: LoRaParams, samples, min_symbols: int = 4,
                    threshold: float = 8.0) -> SyncResult:
    """Find the preamble and estimate CFO and timing.

    Windows whose dechirped peak dominates the floor AND agree on the peak
    bin for >= min_symbols consecutive symbol periods mark the preamble
    (all preamble upchirps land on one bin). The agreement test wraps
    around the end of the capture, as the reference's `roll` does. The
    common bin gives the combined CFO + timing offset, the SFD bin splits
    them, and the preamble peak's fractional part gives the fine CFO.
    `detected` gates the rest: when it is False, the other fields describe
    window 0.
    """
    n = params.samples_per_symbol
    k = params.chips_per_symbol
    x = to_tensor(samples, IQ_DTYPE)
    power, starts = dechirp_windows(params, x, n // PER_SYMBOL)
    dev = x.device
    if power.shape[0] == 0:
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return SyncResult(torch.zeros((), dtype=torch.bool, device=dev), z, z,
                          torch.zeros((), dtype=REAL_DTYPE, device=dev), z)
    detected, cand, peak, bins = preamble_candidates(power, min_symbols, threshold)
    # refine: the best-aligned window within the next symbol span, the
    # first of tied ones (an argmax can pick the window half a symbol in,
    # where the timing wraps)
    best = cand[first_peak(peak[cand])]
    w0 = starts[best]
    # signed up-dechirp bin: b_up ≡ f_bins − τ_chips (mod K)
    pre_bin = bins[best]
    b_up = torch.where(pre_bin > k // 2, pre_bin - k, pre_bin).to(torch.int32)
    # SFD downchirp, dechirped with the UP chirp: b_down ≡ f_bins + τ_chips.
    # SFD begins (preamble_length + 2) symbols after the frame start; the
    # clip keeps its window inside the capture.
    sfd_start = torch.clamp(w0 + (params.preamble_length + 2) * n, 0, max(x.shape[-1] - n, 0))
    sfd_win = x[sfd_start + torch.arange(n, device=dev)]
    pow_sfd = _dechirp_rows(params, sfd_win[None, :], chirp_mod.base_upchirp(params, dev))[0]
    sfd_bin = first_peak(pow_sfd).to(torch.int32)
    b_down = torch.where(sfd_bin > k // 2, sfd_bin - k, sfd_bin)
    # separate CFO and timing: f = (b_up + b_down)/2, τ = (b_down − b_up)/2
    f_bins = (b_up + b_down) / 2.0
    tau_chips = (b_down - b_up) / 2.0
    # fine CFO from the interpolated preamble peak fraction
    frac_idx, _ = find_peak_interpolated(
        torch.sqrt(torch.clamp_min(power[best], 0.0)).to(REAL_DTYPE)[None, :])
    frac = frac_idx[0] - torch.round(frac_idx[0])
    cfo_hz = (f_bins + frac) * (params.bw_hz / k)
    frame_start = w0 + torch.round(tau_chips).to(torch.int32) * params.oversample
    payload_start = frame_start + params.n_preamble_samples()
    return SyncResult(detected, frame_start, payload_start, cfo_hz.to(REAL_DTYPE), pre_bin)


def synchronize(params: LoRaParams, samples):
    """Full sync: detect the preamble, remove the CFO, and return the
    payload-aligned samples trimmed to whole symbols, with the SyncResult;
    (None, result) when nothing is detected or the payload starts past the
    end. Reads `detected` and `payload_start` on the host."""
    x = to_tensor(samples, IQ_DTYPE)
    res = detect_preamble(params, x)
    if not bool(res.detected):
        return None, res
    n0 = int(res.payload_start)
    if n0 >= x.shape[-1]:
        return None, res
    t = (torch.arange(x.shape[-1] - n0, dtype=REAL_DTYPE, device=x.device)
         / real_scalar(params.sample_rate, x.device))
    corrected = x[n0:] * cis(-2 * math.pi * (res.cfo_hz * t))
    n = params.samples_per_symbol
    s = corrected.shape[-1] // n
    return corrected[: s * n], res
