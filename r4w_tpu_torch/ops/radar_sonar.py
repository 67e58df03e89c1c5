"""Radar, sonar and lidar applied processing: the pulse-Doppler chain,
range migration, bistatic maps, ISAR, SAS backprojection, sonar TVG,
bottom profiling, PPI scan conversion, waveform classification, pulse
descriptors, the FMCW automotive chain, lidar peaks and point clouds, GPR,
OTDR, NDT, RCS, weather clutter and wind profiling.

PyTorch counterpart of ``r4w_tpu.ops.radar_sonar`` (pulse_doppler_processor.rs,
matched_filter_pulse_radar.rs, chirp_compressor.rs, range_doppler_detector.rs,
range_migration_correction.rs, range_velocity_decoupling_processor.rs,
bistatic_radar_processor.rs, inverse_synthetic_aperture_imager.rs,
synthetic_aperture_sonar.rs, sonar_processor.rs, sonar_bottom_profiler.rs,
radar_display.rs, radar_waveform_classifier.rs,
pulse_descriptor_extractor.rs, parametric_doppler_estimator.rs,
tracking_doppler_estimator.rs, doppler_pre_correction.rs,
fmcw_automotive_processor.rs, lidar_peak_matcher.rs,
lidar_point_cloud_processor.rs, gpr_subsurface_imager.rs,
gpr_target_discriminator.rs, otdr_pulse_analyzer.rs,
ultrasonic_ndt_processor.rs, radar_cross_section_estimator.rs,
weather_radar_clutter_suppressor.rs, wind_profiler_radar.rs). A (pulse,
range) cube may carry leading batch axes (beams, elements, CPIs): the
matched filter, the pulse-Doppler map and its CFAR, the clutter notch and
the wind profile work on the last two axes and equal the reference on its
2-D cube.

|x| of complex samples is `core.hostio.complex_abs` (the reference's
compiled formula, and card = CPU) wherever a decision follows from it.
`sas_image` and `radar_display_ppi` truncate float32 ranges and angles to
indices, so their square roots are taken in float64 and rounded once (the
correctly rounded float32 root of the reference; torch's float32 `sqrt` on
the CPU is not correctly rounded). `pulse_descriptors` clamps its
``csum[starts]`` gather, which the reference reads one past the end in its
unused slots and XLA clamps silently. `lidar_peak_match` sorts stably, as
``jnp.argsort`` does. Float cumulative sums accumulate in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs, linspace, magnitude
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops import radar as _radar
from r4w_tpu_torch.ops.detect import _median
from r4w_tpu_torch.ops.events import masked_indices, refractory_trigger

# ------------------------------------------------------- pulse Doppler


def matched_filter_pulses(cube, replica):
    """Range-compress every pulse against the transmit replica in one
    batched FFT (matched_filter_pulse_radar.rs / chirp_compressor.rs).
    cube (..., n_pulses, n_range)."""
    c = to_tensor(cube, IQ_DTYPE)
    r = to_tensor(replica, IQ_DTYPE, device=c.device)
    n = c.shape[-1]
    nfft = 1 << (2 * n - 1).bit_length()
    spec = torch.fft.fft(c, nfft, dim=-1) * torch.conj(torch.fft.fft(r, nfft))
    return torch.fft.ifft(spec, dim=-1)[..., :n]


def pulse_doppler_process(cube, replica=None, window: bool = True):
    """Full pulse-Doppler map (pulse_doppler_processor.rs): range
    compression, slow-time Hann window, Doppler FFT. Returns the
    (..., n_doppler, n_range) magnitude map, fftshifted in Doppler."""
    c = to_tensor(cube, IQ_DTYPE)
    if replica is not None:
        c = matched_filter_pulses(c, replica)
    if window:
        w = torch.from_numpy(np.hanning(c.shape[-2]).astype(np.float32)).to(c.device)
        c = c * w[:, None]
    return complex_abs(torch.fft.fftshift(torch.fft.fft(c, dim=-2), dim=-2))


def range_doppler_detect(cube, replica=None, guard: int = 2, train: int = 8, pfa: float = 1e-4):
    """Pulse-Doppler map + 2-D CFAR detections (range_doppler_detector.rs).
    Returns (map, detection mask)."""
    rd = pulse_doppler_process(cube, replica)
    det, _thresh = _radar.cfar_2d(rd ** 2, guard, train, pfa)
    return rd, det


def range_migration_correct(cube, range_rate_bins_per_pulse: float):
    """Keystone-style range-walk correction (range_migration_correction.rs):
    per-pulse frequency-domain shift by the known migration rate, one
    phase-ramp multiply."""
    c = to_tensor(cube, IQ_DTYPE)
    n_pulses, n_range = c.shape[-2:]
    f = torch.from_numpy(np.fft.fftfreq(n_range).astype(np.float32)).to(c.device)
    shifts = torch.arange(n_pulses, dtype=REAL_DTYPE, device=c.device) * range_rate_bins_per_pulse
    ramp = cis(-2.0 * math.pi * shifts[:, None] * f[None, :])
    return torch.fft.ifft(torch.fft.fft(c, dim=-1) * ramp, dim=-1)


def range_velocity_decouple(rd_map_up, rd_map_down, rng_axis, vel_axis):
    """Resolve FMCW range-velocity coupling from up + down chirp maps
    (range_velocity_decoupling_processor.rs): the beat frequencies add and
    subtract; intersect the two detections."""
    up = to_tensor(rd_map_up, REAL_DTYPE)
    dn = to_tensor(rd_map_down, REAL_DTYPE, device=up.device)
    axis = to_tensor(rng_axis, REAL_DTYPE, device=up.device)
    ku = torch.argmax(up) % up.shape[-1]
    kd = torch.argmax(dn) % dn.shape[-1]
    f_up = torch.index_select(axis, 0, ku.reshape(1))[0]
    f_dn = torch.index_select(axis, 0, kd.reshape(1))[0]
    two = real_scalar(2.0, up.device)
    del vel_axis
    return (f_up + f_dn) / two, (f_dn - f_up) / two


def doppler_pre_correct(x, doppler_hz: float, sample_rate: float):
    """Remove a known Doppler before correlation (doppler_pre_correction.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    ph = (-2.0 * np.pi * doppler_hz / sample_rate) * torch.arange(
        x.shape[0], dtype=REAL_DTYPE, device=x.device)
    return x * cis(ph)


def _lag1_phase(x: torch.Tensor, dim: int) -> torch.Tensor:
    """angle(mean(x[1:]·conj(x[:-1]))) along `dim`."""
    n = x.shape[dim]
    prod = x.narrow(dim, 1, n - 1) * torch.conj(x.narrow(dim, 0, n - 1))
    return torch.angle(torch.mean(prod, dim=dim))


def parametric_doppler_estimate(x, sample_rate: float):
    """Single-tone Doppler from the phase of the lag-1 autocorrelation
    (parametric_doppler_estimator.rs, the pulse-pair estimator)."""
    return _lag1_phase(to_tensor(x, IQ_DTYPE), 0) * sample_rate / (2.0 * np.pi)


def tracking_doppler_estimate(pulses, prf: float):
    """Per-burst pulse-pair Doppler track across a (n_bursts, n_pulses)
    slow-time matrix (tracking_doppler_estimator.rs)."""
    return _lag1_phase(to_tensor(pulses, IQ_DTYPE), -1) * prf / (2.0 * np.pi)


# ----------------------------------------------------------- bistatic


def bistatic_range_doppler(ref, surv, n_doppler: int = 64, n_range: int = 256):
    """Bistatic cross-ambiguity map (bistatic_radar_processor.rs): the
    Doppler shifts as one (n_doppler, N) product, then one FFT
    correlation against the reference."""
    r = to_tensor(ref, IQ_DTYPE)
    s = to_tensor(surv, IQ_DTYPE, device=r.device)
    n = r.shape[0]
    dops = linspace(-0.5, 0.5, n_doppler, r.device) * n_doppler
    t = torch.arange(n, dtype=REAL_DTYPE, device=r.device) / real_scalar(n, r.device)
    shifted = s[None, :] * cis(-2.0 * np.pi * dops[:, None] * t[None, :])
    nfft = 1 << (2 * n - 1).bit_length()
    spec = torch.fft.fft(shifted, nfft, dim=-1) * torch.conj(torch.fft.fft(r, nfft))[None, :]
    return complex_abs(torch.fft.ifft(spec, dim=-1)[:, :n_range])


# --------------------------------------------------------------- ISAR


def isar_image(cube, replica=None):
    """ISAR image of a rotating target (inverse_synthetic_aperture_imager.rs):
    range compression + cross-range FFT, the pulse-Doppler map imaged."""
    return pulse_doppler_process(cube, replica)


def _sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of float32 `v`."""
    return torch.sqrt(v.double()).to(REAL_DTYPE)


def sas_image(pings, replica, positions_m, pixel_x, pixel_r, c: float = 1500.0,
              fs: float = 100e3):
    """Synthetic-aperture-sonar backprojection (synthetic_aperture_sonar.rs /
    synthetic_aperture_sonar_imager.rs): range-compress each ping, then sum
    coherently along the track for every pixel, one (pings, pixels) gather
    and sum."""
    comp = matched_filter_pulses(pings, replica)                      # (P, R)
    dev = comp.device
    pos = to_tensor(positions_m, REAL_DTYPE, device=dev)              # (P,)
    px = to_tensor(pixel_x, REAL_DTYPE, device=dev)                   # (X,)
    pr = to_tensor(pixel_r, REAL_DTYPE, device=dev)                   # (Y,)
    dx = px[None, :, None] - pos[:, None, None]                       # (P, X, 1)
    rng = _sqrt_f32(dx ** 2 + pr[None, None, :] ** 2)                 # (P, X, Y)
    idx = torch.clamp((2.0 * rng / real_scalar(c, dev) * fs).to(torch.int32), 0,
                      comp.shape[-1] - 1)
    gathered = torch.gather(comp, -1, idx.reshape(comp.shape[0], -1).long()).reshape(idx.shape)
    return complex_abs(torch.sum(gathered, dim=0))


# -------------------------------------------------------------- sonar


def sonar_process(rx, replica, fs: float, c: float = 1500.0, alpha_db_per_m: float = 0.0):
    """Active-sonar receive chain (sonar_processor.rs): matched filter +
    time-varying gain (spreading + absorption compensation). Returns
    (envelope, range_m axis)."""
    y = matched_filter_pulses(to_tensor(rx, IQ_DTYPE)[None, :], replica)[0]
    n = y.shape[0]
    rng = torch.arange(n, dtype=REAL_DTYPE, device=y.device) * (c / (2.0 * fs))
    tvg_db = 40.0 * torch.log10(torch.clamp(rng, min=1.0)) + 2.0 * alpha_db_per_m * rng
    gain = torch.pow(real_scalar(10.0, y.device), tvg_db / real_scalar(20.0, y.device))
    return complex_abs(y) * gain, rng


def bottom_profile(pings, fs: float, c: float = 1500.0, threshold_rel: float = 0.5,
                   blank: int = 32):
    """First-bottom-return depth track (sonar_bottom_profiler.rs): per-ping
    leading-edge detection above a relative threshold."""
    p = magnitude(pings)                              # (..., P, N)
    p[..., :blank] = 0.0                              # TX blanking
    peak = torch.amax(p, dim=-1, keepdim=True)
    first = torch.argmax((p > threshold_rel * peak).to(torch.uint8), dim=-1)
    return first.to(REAL_DTYPE) * (c / (2.0 * fs))


# ------------------------------------------------------------- display


def radar_display_ppi(scan, n_xy: int = 128):
    """Polar -> cartesian PPI scan conversion (radar_display.rs):
    (n_azimuth, n_range) -> (n_xy, n_xy) by one nearest gather."""
    s = to_tensor(scan, REAL_DTYPE)
    n_az, n_rng = s.shape
    xs = linspace(-1.0, 1.0, n_xy, s.device)
    yy, xx = torch.meshgrid(xs, xs, indexing="ij")
    rr = _sqrt_f32(xx ** 2 + yy ** 2)
    two_pi = real_scalar(2.0 * np.pi, s.device)
    th = torch.remainder(torch.atan2(yy, xx) + two_pi, two_pi)
    ri = torch.clamp((rr * (n_rng - 1)).to(torch.int32), 0, n_rng - 1)
    ai = torch.clamp((th / two_pi * n_az).to(torch.int32), 0, n_az - 1)
    img = s[ai.long(), ri.long()]
    return torch.where(rr <= 1.0, img, 0.0)


# --------------------------------------------------------- classifiers


def radar_waveform_features(x, sample_rate: float):
    """Feature vector for waveform classification (radar_waveform_classifier.rs):
    envelope CV, IF slope (chirp rate), phase-step kurtosis (phase coding),
    spectral occupancy."""
    x = to_tensor(x, IQ_DTYPE)
    mag = complex_abs(x)
    env_cv = torch.std(mag, correction=0) / torch.clamp(torch.mean(mag), min=1e-12)
    d = x[1:] * torch.conj(x[:-1])
    dphi = torch.angle(d)
    inst_f = dphi * sample_rate / (2.0 * np.pi)
    t = torch.arange(inst_f.shape[0], dtype=REAL_DTYPE, device=x.device)
    slope = ((torch.mean(t * inst_f) - torch.mean(t) * torch.mean(inst_f))
             / torch.clamp(torch.var(t, correction=0), min=1e-12))
    step_kurt = (torch.mean((dphi - torch.mean(dphi)) ** 4)
                 / torch.clamp(torch.var(dphi, correction=0) ** 2, min=1e-12))
    spec = complex_abs(torch.fft.fft(x)) ** 2
    occ = torch.sum(spec > 0.05 * torch.max(spec)) / real_scalar(spec.shape[0], x.device)
    return torch.stack([env_cv, slope, step_kurt, occ.to(REAL_DTYPE)])


def radar_waveform_classify(x, sample_rate: float) -> str:
    """Rule-based classification into cw/lfm/phase-coded/noise
    (radar_waveform_classifier.rs)."""
    env_cv, slope, step_kurt, _occ = radar_waveform_features(x, sample_rate).cpu().numpy()
    if env_cv > 0.5:
        return "noise"
    if abs(slope) > 1e-4 * sample_rate:
        return "lfm"
    if step_kurt > 6.0:
        return "phase-coded"
    return "cw"


def pulse_descriptors(x, sample_rate: float, threshold_rel: float = 0.3, max_pulses: int = 32):
    """Pulse-descriptor words (pulse_descriptor_extractor.rs) in the
    reference's fixed-capacity form: (toa_s[K], width_s[K], amp[K],
    freq_hz[K], valid[K]) for K = max_pulses in time order, `valid` False
    for sub-2-sample blips and unused slots. Per-pulse statistics come from
    cumulative-sum differences and one (K, N) masked max."""
    x = to_tensor(x)
    dev = x.device
    mag = magnitude(x)
    n = mag.shape[0]
    on = mag > threshold_rel * torch.max(mag)
    off = torch.zeros(1, dtype=torch.bool, device=dev)
    prev = torch.cat([off, on[:-1]])
    nxt = torch.cat([on[1:], off])
    starts, sv = masked_indices(on & ~prev, max_pulses)
    stops_inc, _ev = masked_indices(on & ~nxt, max_pulses)
    stops = torch.where(sv, stops_inc + 1, n)  # exclusive end
    width = stops - starts
    valid = sv & (width >= 2)
    # intra-pulse frequency from the phase of sum(x[i+1]·conj(x[i])) over
    # [s, e-1): one cumulative sum, one gather difference. An unused slot's
    # start is n, one past csum's end: the reference's gather clamps it.
    d = x[1:] * torch.conj(x[:-1])
    wide = torch.complex128 if d.is_complex() else torch.float64
    csum = torch.cat([torch.zeros(1, dtype=d.dtype, device=dev),
                      torch.cumsum(d.to(wide), dim=0).to(d.dtype)])
    seg_sum = (csum[torch.clamp(stops - 1, max=n - 1).long()]
               - csum[torch.clamp(starts, max=n - 1).long()])
    freq = torch.angle(seg_sum) * sample_rate / (2.0 * np.pi)
    i = torch.arange(n, device=dev)
    in_seg = (i[None, :] >= starts[:, None]) & (i[None, :] < stops[:, None])
    amp = torch.amax(torch.where(in_seg, mag[None, :], 0.0), dim=1)
    fs = real_scalar(sample_rate, dev)
    return (torch.where(valid, starts.to(REAL_DTYPE) / fs, 0.0),
            torch.where(valid, width.to(REAL_DTYPE) / fs, 0.0),
            torch.where(valid, amp, 0.0),
            torch.where(valid, freq, 0.0), valid)


# ------------------------------------------------------- FMCW automotive


def fmcw_automotive(cube, n_rx: int = 4):
    """Automotive FMCW pipeline (fmcw_automotive_processor.rs):
    (n_rx, n_chirps, n_samples) -> range FFT -> Doppler FFT -> angle FFT at
    the strongest cell. Returns the (doppler, range) map and that cell's
    angle spectrum."""
    c = to_tensor(cube, IQ_DTYPE)
    rng_fft = torch.fft.fft(c, dim=-1)
    dop_fft = torch.fft.fftshift(torch.fft.fft(rng_fft, dim=1), dim=1)
    rd = torch.mean(complex_abs(dop_fft), dim=0)          # (chirps, samples)
    k = torch.argmax(rd).reshape(1)
    cell = torch.index_select(dop_fft.reshape(dop_fft.shape[0], -1), 1, k)[:, 0]
    angle_spec = complex_abs(torch.fft.fftshift(torch.fft.fft(cell, 64)))
    del n_rx
    return rd, angle_spec


# ---------------------------------------------------------------- lidar


def lidar_peak_match(waveform, template, max_returns: int = 4, min_sep: int = 8):
    """Multi-return lidar peak extraction (lidar_peak_matcher.rs): correlate
    with the pulse template, pick up to max_returns peaks at least min_sep
    apart. Returns (R, 2) rows of (index, value) sorted by index, invalid
    rows (-1, -inf)."""
    w = to_tensor(waveform, REAL_DTYPE)
    t = to_tensor(template, REAL_DTYPE, device=w.device)
    corr = w.unfold(0, t.shape[0], 1) @ t                 # 'valid' correlation
    thr = 0.3 * torch.max(corr)
    bins = torch.arange(corr.shape[0], device=w.device)
    c = corr
    idxs, vals = [], []
    for _ in range(max_returns):
        k = torch.argmax(c)
        idxs.append(k.to(REAL_DTYPE))
        vals.append(torch.index_select(c, 0, k.reshape(1))[0])
        c = torch.where(torch.abs(bins - k) < min_sep, -math.inf, c)
    idx_f = torch.stack(idxs)
    val_f = torch.stack(vals)
    valid = val_f > thr
    order = torch.argsort(torch.where(valid, idx_f, math.inf), stable=True)
    idx_s = torch.where(valid[order], idx_f[order], -1.0)
    val_s = torch.where(valid[order], val_f[order], -math.inf)
    return torch.stack([idx_s, val_s], dim=-1)


def lidar_point_cloud(ranges_m, az_deg, el_deg, device=None):
    """Spherical -> cartesian point cloud (lidar_point_cloud_processor.rs).
    Inputs broadcast together."""
    r = to_tensor(ranges_m, REAL_DTYPE, device=device)
    az = torch.deg2rad(to_tensor(az_deg, REAL_DTYPE, device=r.device))
    el = torch.deg2rad(to_tensor(el_deg, REAL_DTYPE, device=r.device))
    x = r * torch.cos(el) * torch.cos(az)
    y = r * torch.cos(el) * torch.sin(az)
    z = r * torch.sin(el)
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


# ----------------------------------------------------------------- GPR


def _analytic_mask(n: int, device) -> torch.Tensor:
    m = np.zeros(n)
    m[0] = 1.0
    m[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        m[n // 2] = 1.0
    return torch.from_numpy(m.astype(np.complex64)).to(device)


def gpr_image(traces, background_frac: float = 1.0):
    """GPR B-scan imaging (gpr_subsurface_imager.rs): mean-trace background
    removal + envelope."""
    t = to_tensor(traces, REAL_DTYPE)                  # (n_traces, n_t)
    clean = t - torch.mean(t, dim=0, keepdim=True) * background_frac
    return complex_abs(torch.fft.ifft(
        torch.fft.fft(clean, dim=-1) * _analytic_mask(clean.shape[-1], t.device)[None, :],
        dim=-1))


def gpr_discriminate(image, patch: int = 16):
    """Hyperbola-vs-layer discrimination (gpr_target_discriminator.rs): local
    horizontal-vs-vertical gradient energy ratio per patch."""
    img = to_tensor(image, REAL_DTYPE)
    gx = torch.abs(torch.diff(img, dim=0))[:, :-1]
    gy = torch.abs(torch.diff(img, dim=-1))[:-1, :]
    h, w = gx.shape
    ph, pw = h // patch, w // patch
    gx_p = gx[:ph * patch, :pw * patch].reshape(ph, patch, pw, patch).mean((1, 3))
    gy_p = gy[:ph * patch, :pw * patch].reshape(ph, patch, pw, patch).mean((1, 3))
    return gx_p / torch.clamp(gy_p, min=1e-9)


# ----------------------------------------------------------- OTDR / NDT


def otdr_analyze(trace_db, fs: float, pulse_ns: float = 100.0, event_threshold_db: float = 0.3,
                 max_events: int = 32):
    """OTDR event analysis (otdr_pulse_analyzer.rs): the fiber's
    attenuation slope (the median first difference, immune to the event
    steps) and reflective/loss events with a pulse-width dead time.
    Returns (slope, positions[K], is_reflection[K], magnitude_db[K],
    valid[K]) with K = max_events."""
    y = to_tensor(trace_db, REAL_DTYPE)
    dy = torch.diff(y)
    slope_db_per_samp = _median(dy)[0]   # jnp.median: the two middle values' mean
    d = dy - slope_db_per_samp
    skip = int(max(1, pulse_ns * 1e-9 * fs))
    fires, valid = masked_indices(refractory_trigger(torch.abs(d) > event_threshold_db, skip),
                                  max_events)
    dpad = torch.cat([d, torch.zeros(1, dtype=d.dtype, device=d.device)])
    at = dpad[fires.long()]
    return (slope_db_per_samp, fires + 1, at > 0, torch.where(valid, torch.abs(at), 0.0), valid)


def ndt_thickness(echo, fs: float, velocity: float = 5900.0, min_sep: int = 8):
    """Ultrasonic thickness from back-wall echo spacing
    (ultrasonic_ndt_processor.rs): the envelope's autocorrelation gives the
    round-trip interval. Returns (thickness m, lag samples)."""
    e = torch.abs(to_tensor(echo, REAL_DTYPE))
    e = e - torch.mean(e)
    n = e.shape[0]
    f = torch.fft.rfft(e, 2 * n)
    ac = torch.fft.irfft(f * torch.conj(f), 2 * n)[:n]
    k = min_sep + torch.argmax(ac[min_sep: n // 2])
    return velocity * k.to(REAL_DTYPE) / real_scalar(2.0 * fs, e.device), k.to(torch.int32)


# ------------------------------------------------------------- weather


def rcs_estimate(pr_w, pt_w: float, g_tx: float, g_rx: float, wavelength_m: float,
                 range_m: float):
    """Radar-equation RCS solve (radar_cross_section_estimator.rs):
    σ = Pr (4π)³ R⁴ / (Pt G² λ²)."""
    num = pr_w * (4.0 * np.pi) ** 3 * range_m ** 4
    den = pt_w * g_tx * g_rx * wavelength_m ** 2
    return num / den


def weather_clutter_suppress(cube, notch_width: int = 1):
    """Ground-clutter suppression for weather radar
    (weather_radar_clutter_suppressor.rs): zero the zero-Doppler bins of
    the slow-time spectrum (axis -2), keep the weather return. An indexed
    assignment, as the reference's ``.at[idx].set``."""
    c = to_tensor(cube, IQ_DTYPE)
    spec = torch.fft.fft(c, dim=-2)
    n = c.shape[-2]
    idx = np.concatenate([np.arange(notch_width + 1), n - 1 - np.arange(notch_width)])
    spec[..., torch.from_numpy(idx).to(c.device), :] = 0.0
    return torch.fft.ifft(spec, dim=-2)


def wind_profile(cube, prf: float, heights_m):
    """Wind-profiler radial velocities per range gate (wind_profiler_radar.rs):
    pulse-pair Doppler at each height. cube (..., pulses, gates)."""
    del heights_m
    return _lag1_phase(to_tensor(cube, IQ_DTYPE), -2) * prf / (2.0 * np.pi)


BLOCKS = {
    "matched_filter_pulse_radar": ("matched_filter_pulses", "radar",
                                   "batched range compression "
                                   "(matched_filter_pulse_radar.rs)"),
    "pulse_doppler_processor": ("pulse_doppler_process", "radar",
                                "range + Doppler FFT map "
                                "(pulse_doppler_processor.rs)"),
    "range_doppler_detector": ("range_doppler_detect", "radar",
                               "RD map + 2-D CFAR "
                               "(range_doppler_detector.rs)",
                               ("guard", "train", "pfa")),
    "range_migration_correction": ("range_migration_correct", "radar",
                                   "keystone range-walk fix "
                                   "(range_migration_correction.rs)",
                                   ("range_rate_bins_per_pulse",)),
    "range_velocity_decoupling": ("range_velocity_decouple", "radar",
                                  "FMCW up/down disambiguation "
                                  "(range_velocity_decoupling_"
                                  "processor.rs)"),
    "doppler_pre_correction": ("doppler_pre_correct", "radar",
                               "known-Doppler removal "
                               "(doppler_pre_correction.rs)",
                               ("doppler_hz", "sample_rate")),
    "parametric_doppler_estimator": ("parametric_doppler_estimate",
                                     "radar",
                                     "pulse-pair Doppler "
                                     "(parametric_doppler_estimator.rs)",
                                     ("sample_rate",)),
    "tracking_doppler_estimator": ("tracking_doppler_estimate", "radar",
                                   "per-burst Doppler track "
                                   "(tracking_doppler_estimator.rs)",
                                   ("prf",)),
    "bistatic_radar_processor": ("bistatic_range_doppler", "radar",
                                 "cross-ambiguity map "
                                 "(bistatic_radar_processor.rs)",
                                 ("n_doppler", "n_range")),
    "isar_imager": ("isar_image", "radar",
                    "rotating-target ISAR "
                    "(inverse_synthetic_aperture_imager.rs)"),
    "sas_imager": ("sas_image", "radar",
                   "synthetic-aperture-sonar backprojection "
                   "(synthetic_aperture_sonar_imager.rs)"),
    "sonar_processor": ("sonar_process", "radar",
                        "matched filter + TVG (sonar_processor.rs)",
                        ("fs", "alpha_db_per_m")),
    "sonar_bottom_profiler": ("bottom_profile", "radar",
                              "first-return depth track "
                              "(sonar_bottom_profiler.rs)",
                              ("fs", "threshold_rel")),
    "radar_display": ("radar_display_ppi", "sink",
                      "polar->cartesian PPI (radar_display.rs)",
                      ("n_xy",)),
    "radar_waveform_classifier": ("radar_waveform_classify", "radar",
                                  "cw/lfm/phase-coded classifier "
                                  "(radar_waveform_classifier.rs)",
                                  ("sample_rate",)),
    "pulse_descriptor_extractor": ("pulse_descriptors", "radar",
                                   "PDW extraction "
                                   "(pulse_descriptor_extractor.rs)",
                                   ("sample_rate",)),
    "fmcw_automotive_processor": ("fmcw_automotive", "radar",
                                  "range/Doppler/angle FFT chain "
                                  "(fmcw_automotive_processor.rs)"),
    "lidar_peak_matcher": ("lidar_peak_match", "radar",
                           "multi-return peak extraction "
                           "(lidar_peak_matcher.rs)",
                           ("max_returns", "min_sep")),
    "lidar_point_cloud": ("lidar_point_cloud", "radar",
                          "spherical->cartesian cloud "
                          "(lidar_point_cloud_processor.rs)"),
    "gpr_subsurface_imager": ("gpr_image", "radar",
                              "B-scan background removal + envelope "
                              "(gpr_subsurface_imager.rs)"),
    "gpr_target_discriminator": ("gpr_discriminate", "radar",
                                 "hyperbola/layer gradient ratio "
                                 "(gpr_target_discriminator.rs)",
                                 ("patch",)),
    "otdr_pulse_analyzer": ("otdr_analyze", "measurement",
                            "fiber slope + event list "
                            "(otdr_pulse_analyzer.rs)", ("fs",)),
    "ultrasonic_ndt": ("ndt_thickness", "measurement",
                       "echo-spacing thickness "
                       "(ultrasonic_ndt_processor.rs)",
                       ("fs", "velocity")),
    "radar_cross_section_estimator": ("rcs_estimate", "radar",
                                      "radar-equation RCS solve "
                                      "(radar_cross_section_"
                                      "estimator.rs)"),
    "weather_radar_clutter_suppressor": (
        "weather_clutter_suppress", "radar",
        "zero-Doppler notch (weather_radar_clutter_suppressor.rs)",
        ("notch_width",)),
    "wind_profiler_radar": ("wind_profile", "radar",
                            "per-gate radial winds "
                            "(wind_profiler_radar.rs)", ("prf",)),
}
