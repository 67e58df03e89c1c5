"""Advanced radar and array processing: STAP, clutter filtering, coherent
integration and radar target tracking.

PyTorch counterpart of ``r4w_tpu.ops.radar_adv``
(space_time_adaptive_processor.rs, clutter_filter.rs,
coherent_integrator.rs, automotive_radar_tracker.rs,
weather_radar_clutter_suppressor.rs): the joint angle-Doppler weights are
one regularised ``torch.linalg.solve``, clutter rejection is a Doppler
notch, and tracking is the constant-velocity Kalman filter of
`ops.kalman` run per target. `RadarTracker` keeps the reference's
host-side association loop and its numpy track state; each update is the
port's `kalman_step` on `device`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs
from r4w_tpu_torch.core.types import (IQ_DTYPE, REAL_DTYPE, real_scalar, resolve_device,
                                      to_tensor)
from r4w_tpu_torch.ops.kalman import KalmanParams, kalman_step

# ---------------------------------------------------------------- STAP


def space_time_steering(n_elements: int, n_pulses: int, spatial_freq: float,
                        doppler_freq: float, device=None) -> torch.Tensor:
    """Joint space-time steering vector v = d(fd) ⊗ a(fs), spatial_freq and
    doppler_freq in cycles (d·sinθ/λ and fd/PRF)."""
    device = resolve_device(device)
    a = cis(2.0 * np.pi * spatial_freq * torch.arange(n_elements, dtype=REAL_DTYPE,
                                                      device=device))
    d = cis(2.0 * np.pi * doppler_freq * torch.arange(n_pulses, dtype=REAL_DTYPE,
                                                      device=device))
    return torch.kron(d, a)


def stap_weights(snapshots, target_steering, diagonal_loading: float = 1e-3) -> torch.Tensor:
    """Optimum STAP weights w = R⁻¹v / (vᴴR⁻¹v)
    (space_time_adaptive_processor.rs). snapshots (K, N·M) training
    space-time snapshots, target_steering (N·M,); diagonal loading
    regularises the sample covariance."""
    x = to_tensor(snapshots, IQ_DTYPE)
    v = to_tensor(target_steering, IQ_DTYPE, device=x.device)
    k, nm = x.shape
    r = (x.conj().T @ x) / real_scalar(k, x.device)
    load = diagonal_loading * torch.trace(r).real / real_scalar(nm, x.device)
    r = r + load * torch.eye(nm, dtype=IQ_DTYPE, device=x.device)
    rinv_v = torch.linalg.solve(r, v)
    return rinv_v / (v.conj() @ rinv_v)


def stap_output(w, cell_data) -> torch.Tensor:
    """Filter range cells (..., N·M) with the STAP weights."""
    w = to_tensor(w, IQ_DTYPE)
    return to_tensor(cell_data, IQ_DTYPE, device=w.device) @ torch.conj(w)


def sinr_loss(w, steering, r) -> float:
    """SINR of weights w against interference covariance r for a unit
    target along `steering` (a diagnostic, read on the host)."""
    w = to_tensor(w, IQ_DTYPE)
    s = to_tensor(steering, IQ_DTYPE, device=w.device)
    r = to_tensor(r, IQ_DTYPE, device=w.device)
    num = complex_abs(torch.conj(w) @ s) ** 2
    den = (torch.conj(w) @ (r @ w)).real
    return float(num / torch.clamp(den, min=1e-18))


# ------------------------------------------------------------- clutter


def clutter_notch(pulses, n_zero_bins: int = 1) -> torch.Tensor:
    """Doppler-domain zero-velocity clutter rejection (clutter_filter.rs /
    weather_radar_clutter_suppressor.rs): FFT over slow time, zero the
    DC ± n bins, inverse FFT. pulses (..., n_pulses, n_range)."""
    x = to_tensor(pulses, IQ_DTYPE)
    spec = torch.fft.fft(x, dim=-2)
    n = x.shape[-2]
    mask = np.ones(n, np.float32)
    mask[:n_zero_bins + 1] = 0.0
    if n_zero_bins:
        mask[-n_zero_bins:] = 0.0
    return torch.fft.ifft(spec * torch.from_numpy(mask).to(x.device)[:, None], dim=-2)


def coherent_integrate(pulses) -> torch.Tensor:
    """Coherent pulse integration (coherent_integrator.rs): the sum over
    slow time gains N in SNR for phase-stable targets."""
    return torch.sum(to_tensor(pulses, IQ_DTYPE), dim=-2)


def noncoherent_integrate(pulses) -> torch.Tensor:
    """|·|² sum: √N gain, but tolerant of Doppler and phase."""
    p = to_tensor(pulses)
    if p.is_complex():
        return torch.sum(p.real ** 2 + p.imag ** 2, dim=-2)
    return torch.sum(p ** 2, dim=-2)


# ------------------------------------------------------------ tracking


@dataclasses.dataclass
class RadarTrack:
    """One constant-velocity track (automotive_radar_tracker.rs)."""

    x: np.ndarray          # state [r, v]
    cov: np.ndarray
    hits: int = 1
    misses: int = 0
    track_id: int = 0


class RadarTracker:
    """Nearest-neighbour gating + per-track constant-velocity Kalman
    (automotive_radar_tracker.rs): confirm after `confirm_hits`, drop after
    `max_misses`. The association runs on the host over numpy states; each
    update is one `kalman_step` on `device` (default: the card)."""

    def __init__(self, dt: float, gate: float = 30.0, q_accel: float = 1.0,
                 meas_var: float = 4.0, confirm_hits: int = 2, max_misses: int = 3,
                 device=None):
        self.device = resolve_device(device)
        self.params = KalmanParams.constant_velocity(dt, q_accel, meas_var, device=self.device)
        self.dt = dt
        self.meas_var = meas_var
        self.gate = gate
        self.confirm_hits = confirm_hits
        self.max_misses = max_misses
        self.tracks: list[RadarTrack] = []
        self._next_id = 0

    def _update(self, tr: RadarTrack, z: float) -> None:
        dev = self.device
        x, cov = kalman_step(self.params, torch.as_tensor(tr.x, dtype=REAL_DTYPE, device=dev),
                             torch.as_tensor(tr.cov, dtype=REAL_DTYPE, device=dev),
                             torch.tensor([z], dtype=REAL_DTYPE, device=dev))
        tr.x, tr.cov = x.cpu().numpy(), cov.cpu().numpy()

    def step(self, detections_m) -> list[RadarTrack]:
        """One scan of range detections; returns the confirmed tracks."""
        dets = list(np.atleast_1d(np.asarray(detections_m, np.float64)))
        used = set()
        for tr in self.tracks:
            pred = tr.x[0] + tr.x[1] * self.dt         # predicted range
            best, best_d = None, self.gate
            for i, z in enumerate(dets):
                if i in used:
                    continue
                if abs(z - pred) < best_d:
                    best, best_d = i, abs(z - pred)
            if best is None:
                tr.misses += 1
                tr.x = np.asarray([pred, tr.x[1]])     # coast: propagate without update
                continue
            used.add(best)
            self._update(tr, dets[best])
            tr.hits += 1
            tr.misses = 0
        for i, z in enumerate(dets):                   # spawn tracks for the rest
            if i not in used:
                self.tracks.append(RadarTrack(x=np.asarray([z, 0.0]),
                                              cov=np.diag([self.meas_var, 100.0]),
                                              track_id=self._next_id))
                self._next_id += 1
        self.tracks = [t for t in self.tracks if t.misses <= self.max_misses]
        return [t for t in self.tracks if t.hits >= self.confirm_hits]
