"""Detection blocks: energy, burst, silence/VAD, squelch, sync word, zero
crossings, Teager-Kaiser, spectral kurtosis, spectrum sensing, CUSUM.

PyTorch counterpart of ``r4w_tpu.ops.detect`` (signal_detector.rs,
energy_detector.rs, spectrum_sensor.rs, burst_detector.rs,
silence_detector.rs, voice_activity_detector.rs, squelch.rs,
sync_word_detector.rs, zero_crossing_detector.rs,
teager_kaiser_energy.rs, spectral_kurtosis_detector.rs,
blind_spectrum_sensing.rs, spectrum_hole_detector.rs,
spectral_occupancy_monitor.rs, time_series_changepoint_detector.rs).
Samples are on the last axis, leading axes a batch; framing is a reshape,
spectra are batched cuFFT calls.

The burst gate's hysteresis is parallel (`events.latest_set`): with the
open level above the close level, a frame above the open level opens the
gate, one below the close level closes it, and any other frame keeps the
state, so the last decisive frame wins, exactly as the reference's scan.
The median noise floor averages the two middle frames at an even count,
as ``jnp.median`` does. `burst_edges` and `spectrum_holes` are host numpy;
`cusum_changepoint` stays a step loop over the samples, as the reference's
``lax.scan`` is.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import magnitude
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor
from r4w_tpu_torch.ops.events import latest_set, masked_indices


def _frames(x: torch.Tensor, frame: int) -> torch.Tensor:
    n = x.shape[-1] // frame
    return x[..., : n * frame].reshape(*x.shape[:-1], n, frame)


def _median(v: torch.Tensor) -> torch.Tensor:
    """The median over the last axis, keeping it: the mean of the two
    middle values at an even length (``jnp.median``'s rule)."""
    s = torch.sort(v, dim=-1).values
    n = v.shape[-1]
    return (s[..., (n - 1) // 2:(n - 1) // 2 + 1] + s[..., n // 2:n // 2 + 1]) * 0.5


def frame_energy_db(x, frame: int = 256) -> torch.Tensor:
    """Per-frame mean power in dB (the detectors' building block)."""
    p = torch.mean(magnitude(_frames(to_tensor(x), frame)) ** 2, dim=-1)
    return 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def energy_detect(x, frame: int = 256, threshold_db: float = 10.0):
    """Energy detector against the median-frame noise floor
    (signal_detector.rs, blind_spectrum_sensing.rs time-domain mode).
    Returns (mask (..., F) bool, floor_db per row)."""
    e = frame_energy_db(x, frame)
    floor = _median(e)
    return e > floor + threshold_db, floor[..., 0]


def burst_decisions(x, frame: int = 64, on_db: float = 10.0, off_db: float = 6.0):
    """The burst gate's inputs: (frame energies dB, the floor (..., 1), the
    frames above floor + on_db, the frames below floor + off_db)."""
    e = frame_energy_db(x, frame)
    floor = _median(e)
    return e, floor, e > floor + on_db, e < floor + off_db


def burst_detect(x, frame: int = 64, on_db: float = 10.0, off_db: float = 6.0):
    """Hysteresis burst gate (burst_detector.rs): opens at floor + on_db,
    closes at floor + off_db. Returns the per-frame bool mask."""
    _, _, on, off = burst_decisions(x, frame, on_db, off_db)
    if on_db > off_db:  # a frame is never both above on and below off
        mask, _ = latest_set(on | off, on)
        return mask
    state = torch.zeros(on.shape[:-1], dtype=torch.bool, device=on.device)
    mask = torch.empty_like(on)
    for t in range(on.shape[-1]):  # both at once toggles the state: the scan itself
        state = torch.where(state, ~off[..., t], on[..., t])
        mask[..., t] = state
    return mask


def burst_edges(mask) -> tuple[np.ndarray, np.ndarray]:
    """(starts, stops) frame indices of a 1-D burst mask (host numpy)."""
    m = (mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor)
         else np.asarray(mask)).astype(np.int32)
    d = np.diff(np.concatenate([[0], m, [0]]))
    return np.where(d == 1)[0], np.where(d == -1)[0]


def zero_crossing_rate(x, frame: int = 256) -> torch.Tensor:
    """Per-frame zero-crossing fraction (zero_crossing_detector.rs)."""
    x = to_tensor(x)
    sign = torch.sign(_frames(x.real if x.is_complex() else x, frame))
    flips = torch.abs(torch.diff(sign, dim=-1)) > 1
    return torch.mean(flips.to(REAL_DTYPE), dim=-1)


def voice_activity(audio, frame: int = 256, energy_db: float = 6.0, zcr_max: float = 0.25):
    """Energy + zero-crossing-rate VAD (voice_activity_detector.rs,
    silence_detector.rs): voiced frames have energy above the floor and a
    low ZCR."""
    e = frame_energy_db(audio, frame)
    return (e > _median(e) + energy_db) & (zero_crossing_rate(audio, frame) < zcr_max)


def squelch(x, frame: int = 64, open_db: float = 8.0, close_db: float = 5.0):
    """Power squelch with hysteresis (squelch.rs): (the gated signal, closed
    frames zeroed, and the per-frame gate)."""
    x = to_tensor(x)
    gate = burst_detect(x, frame, open_db, close_db)
    n = gate.shape[-1] * frame
    g_samples = torch.repeat_interleave(gate, frame, dim=-1)
    return x[..., :n] * g_samples.to(REAL_DTYPE if x.is_complex() else x.dtype), gate


def sync_word_correlate(bits, word) -> torch.Tensor:
    """±1 correlation of a bit stream against a sync word
    (sync_word_detector.rs): output[i] = matches at offset i, in
    [0, len(word)]."""
    b = 1.0 - 2.0 * to_tensor(bits, REAL_DTYPE)
    w = 1.0 - 2.0 * to_tensor(word, REAL_DTYPE, device=b.device)
    k = w.shape[-1]
    corr = torch.einsum("...nk,k->...n", b.unfold(-1, k, 1), w)
    return (corr + k) / 2.0


def sync_word_detect(bits, word, max_errors: int = 0, max_matches: int = 64):
    """Offsets where the word matches within max_errors, as a fixed-capacity
    list: (offsets int32[K], valid bool[K]) for the first K = max_matches
    matches in stream order."""
    c = sync_word_correlate(bits, word)
    k = len(word) if not isinstance(word, torch.Tensor) else word.shape[-1]
    return masked_indices(c >= k - max_errors, max_matches)


def teager_kaiser(x) -> torch.Tensor:
    """Teager-Kaiser energy ψ[n] = x²[n] − x[n−1]·x[n+1]
    (teager_kaiser_energy.rs); the |x|² form for complex input."""
    x = to_tensor(x)
    if x.is_complex():
        return magnitude(x[..., 1:-1]) ** 2 - (x[..., :-2] * torch.conj(x[..., 2:])).real
    return x[..., 1:-1] ** 2 - x[..., :-2] * x[..., 2:]


def spectral_kurtosis(x, nfft: int = 256) -> torch.Tensor:
    """Per-bin kurtosis of the STFT power over frames
    (spectral_kurtosis_detector.rs): impulsive bins score well above 0,
    stationary Gaussian noise about 0."""
    spec = torch.fft.fft(_frames(to_tensor(x, IQ_DTYPE), nfft), dim=-1)
    p = spec.real ** 2 + spec.imag ** 2
    m2 = torch.mean(p, dim=-2)
    m4 = torch.mean(p ** 2, dim=-2)
    return m4 / torch.clamp(m2 ** 2, min=1e-30) - 2.0


def spectrum_sense(x, nfft: int = 512, threshold_db: float = 8.0):
    """PSD-based occupancy (blind_spectrum_sensing.rs,
    spectral_occupancy_monitor.rs): the averaged periodogram of every frame
    against its median floor. Returns (occupied (..., nfft) bool in FFT
    order, psd_db fftshifted), as the reference does."""
    spec = torch.fft.fft(_frames(to_tensor(x, IQ_DTYPE), nfft), dim=-1)
    psd = torch.mean(spec.real ** 2 + spec.imag ** 2, dim=-2)
    psd_db = 10.0 * torch.log10(torch.clamp(psd, min=1e-30))
    return psd_db > _median(psd_db) + threshold_db, torch.fft.fftshift(psd_db, dim=-1)


def spectrum_holes(occupied, min_width: int = 4) -> list:
    """Contiguous unoccupied bin ranges (spectrum_hole_detector.rs), host."""
    occ = (occupied.detach().cpu().numpy() if isinstance(occupied, torch.Tensor)
           else np.asarray(occupied)).astype(np.int32)
    d = np.diff(np.concatenate([[1], occ, [1]]))
    starts = np.where(d == -1)[0]
    stops = np.where(d == 1)[0]
    return [(int(a), int(b)) for a, b in zip(starts, stops) if b - a >= min_width]


def cusum_changepoint(x, drift: float = 0.5, threshold: float = 8.0):
    """Two-sided CUSUM on a mean-shifted series
    (time_series_changepoint_detector.rs): (the first alarm's index or -1,
    the cusum+ trace, the cusum- trace). A step loop over the samples."""
    x = to_tensor(x, REAL_DTYPE)
    head = x[..., : max(8, x.shape[-1] // 8)]
    mu = torch.mean(head, dim=-1)
    sigma = torch.clamp(torch.std(head, dim=-1, unbiased=False), min=1e-9)
    z = (x - mu[..., None]) / sigma[..., None]
    gp = torch.zeros(z.shape[:-1], dtype=REAL_DTYPE, device=x.device)
    gm = torch.zeros_like(gp)
    gps, gms = torch.empty_like(z), torch.empty_like(z)
    for t in range(z.shape[-1]):
        gp = torch.clamp(gp + z[..., t] - drift, min=0.0)
        gm = torch.clamp(gm - z[..., t] - drift, min=0.0)
        gps[..., t], gms[..., t] = gp, gm
    over = (gps > threshold) | (gms > threshold)
    first = torch.argmax(over.to(torch.int32), dim=-1).to(torch.int32)
    return torch.where(torch.any(over, dim=-1), first, -1), gps, gms
