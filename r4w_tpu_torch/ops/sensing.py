"""Applied-sensing long-tail fills (geophysics, industrial, photonics,
nuclear, space weather).

PyTorch counterpart of ``r4w_tpu.ops.sensing`` (acoustic_emission_sensor.rs,
acoustic_gunshot_localizer.rs, acoustic_impedance_tomographer.rs,
acoustic_leak_locator.rs, avalanche_transceiver_correlator.rs,
cosmic_ray_detector.rs, dam_seepage_monitor.rs, drone_acoustic_detector.rs,
engine_vibration_signature_analyzer.rs,
fiber_bragg_grating_interrogator.rs, geomagnetic_storm_detector.rs,
gravity_gradiometer_processor.rs, hyperspectral_spectral_unmixing.rs,
ionospheric_scintillation_detector.rs /
ionospheric_scintillation_analyzer.rs, lightning_stroke_analyzer.rs,
magnetic_anomaly_detector.rs, mr_spectroscopy_processor.rs,
nuclear_spectroscopy_analyzer.rs, optical_coherence_tomography.rs,
particle_accelerator_bpm.rs, photoacoustic_image_reconstructor.rs,
plasma_diagnostics_processor.rs, plasma_impedance_analyzer.rs,
precision_ag_soil_sensor.rs, pulse_oximeter_processor.rs,
radiation_detector_processor.rs, railroad_wheel_flat_detector.rs,
reservoir_acoustic_monitor.rs, seismic_arrival_detector.rs /
seismic_processor.rs / seismograph_event_classifier.rs,
structural_health_monitor.rs, tidal_harmonic_analyzer.rs,
turbine_blade_tip_timing.rs, vibration_order_tracker.rs,
wind_turbine_vibration_monitor.rs).

Every median is the mean of the two middle values at an even length
(``jnp.median``'s rule). The float cumulative sums that are differenced
(`acoustic_emission_count`'s energies, `sta_lta`'s averages) and the
order tracker's shaft angle accumulate in float64 and round once
(``filters._cumsum``), so the card's sums are the CPU's: a float32 scan on
the card would round every partial sum in another order. The dynamic
windows (`fbg_wavelength_shift`, `mrs_quantify`) clamp their start so that
they fit, as ``lax.dynamic_slice`` does. `lightning_stroke_analyze` and
`acoustic_emission_count` run on the port's `events` state machines;
`hyperspectral_unmix` is a 200-step loop; `tidal_harmonic_fit` solves the
reference's float32 normal equations. Roots and cosines whose value an
index truncates (`photoacoustic_reconstruct`,
`impedance_tomography_backproject`) are taken in float64 and rounded
once, so the card's indices are the CPU's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from r4w_tpu_torch.core.hostio import complex_abs, linspace, magnitude
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.filters import _cumsum
from r4w_tpu_torch.ops.spectral2 import _real, _std, median
from r4w_tpu_torch.waveforms.serial_tone import interp

# ------------------------------------------------------ acoustic/NDT


def _float(x) -> torch.Tensor:
    """`x` as a tensor, float64 (numpy's default) cast to float32."""
    x = to_tensor(x)
    return x.to(REAL_DTYPE) if x.dtype == torch.float64 else x


def _hanning(n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.hanning(n).astype(np.float32)).to(device)


def _db(p: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def acoustic_emission_count(x, threshold_sigma: float = 5.0, dead_time: int = 32,
                            max_hits: int = 64):
    """AE hit counting + energy (acoustic_emission_sensor.rs): threshold
    crossings with dead-time (`events.deadtime_runs`) in a fixed-capacity
    list: `(n_hits, starts[max_hits], energies[max_hits], valid[max_hits])`,
    n_hits the true count. Energies are differences of the cumulative sum
    of a², accumulated in float64 and rounded once."""
    from r4w_tpu_torch.ops.events import deadtime_runs, masked_indices

    a = magnitude(_float(x))
    thr = threshold_sigma * median(a.reshape(-1)) * 1.4826
    starts_m, ends_m = deadtime_runs(a > thr, dead_time)
    starts, valid = masked_indices(starts_m, max_hits)
    ends, _ = masked_indices(ends_m, max_hits)
    csum = torch.cat([torch.zeros(1, dtype=REAL_DTYPE, device=a.device), _cumsum(a ** 2)])
    energies = torch.where(valid, csum[ends.long()] - csum[starts.long()],
                           torch.zeros((), device=a.device))
    n_hits = torch.sum(starts_m.to(torch.int32), dtype=torch.int32)
    return n_hits, starts, energies, valid


def gunshot_localize(mic_signals, mic_positions_m, fs: float, c: float = 343.0):
    """Acoustic gunshot TDOA localization (acoustic_gunshot_localizer.rs):
    GCC-PHAT of every mic against mic 0 → the EW least-squares TDOA
    solver."""
    from r4w_tpu_torch.ops.ew import gcc_phat, tdoa_localize
    first = to_tensor(mic_signals[0], IQ_DTYPE)
    x = torch.stack([to_tensor(s, IQ_DTYPE, device=first.device) for s in mic_signals])
    lags = torch.stack([gcc_phat(s, x[0])[0] for s in x[1:]])
    dd_m = lags.to(REAL_DTYPE) / real_scalar(fs, x.device) * c
    return tdoa_localize(to_tensor(mic_positions_m, REAL_DTYPE, device=x.device), dd_m)


def impedance_tomography_backproject(boundary_measurements, angles_deg, n_px: int = 32):
    """Filtered-backprojection-style reconstruction from boundary line
    integrals (acoustic_impedance_tomographer.rs): ramp filter per
    projection, all angles in one batched gather."""
    meas = to_tensor(boundary_measurements, REAL_DTYPE)
    n_ang, n_det = meas.shape
    f = torch.from_numpy(np.abs(np.fft.fftfreq(n_det)).astype(np.float32)).to(meas.device)
    filt = torch.fft.ifft(torch.fft.fft(meas.to(IQ_DTYPE), dim=-1) * f[None, :], dim=-1).real
    xs = linspace(-1.0, 1.0, n_px, meas.device)
    yy, xx = torch.meshgrid(xs, xs, indexing="ij")
    ang = torch.deg2rad(to_tensor(angles_deg, REAL_DTYPE, device=meas.device)).double()
    # cos and sin rounded once from float64: the card's and the CPU's float32
    # cos differ by an ulp at some angles, which moves a truncated detector
    cos, sin = torch.cos(ang).to(REAL_DTYPE), torch.sin(ang).to(REAL_DTYPE)
    t = (xx[None] * cos[:, None, None] + yy[None] * sin[:, None, None])
    det = torch.clamp(((t + 1) / 2 * (n_det - 1)).to(torch.int32), 0, n_det - 1)
    img = torch.sum(torch.gather(filt, 1, det.reshape(n_ang, -1).long()).reshape(
        n_ang, n_px, n_px), dim=0)
    return img / real_scalar(float(n_ang), meas.device)


def leak_locate(sensor_a, sensor_b, distance_m: float, fs: float, wave_speed: float = 1200.0):
    """Pipeline leak location from two-sensor cross-correlation
    (acoustic_leak_locator.rs): position from dt = t_B − t_A."""
    from r4w_tpu_torch.ops.ew import gcc_phat
    b = to_tensor(sensor_b, IQ_DTYPE)
    lag, _ = gcc_phat(b, to_tensor(sensor_a, IQ_DTYPE, device=b.device))
    dt = lag.to(REAL_DTYPE) / real_scalar(fs, b.device)
    return (distance_m - wave_speed * dt) / 2.0


def avalanche_beacon_search(x, fs: float, f0: float = 457_000.0, frame_s: float = 0.1):
    """457 kHz avalanche-transceiver pulse detection + field-strength trend
    (avalanche_transceiver_correlator.rs): frames 6 dB over the median."""
    x = to_tensor(x, IQ_DTYPE)
    frame = int(fs * frame_s)
    n = (x.shape[-1] // frame) * frame
    pw = torch.mean(complex_abs(x[..., :n].reshape(*x.shape[:-1], -1, frame)) ** 2, dim=-1)
    pw_db = _db(pw)
    floor = median(pw_db, dim=-1, keepdim=True)
    del f0
    return pw_db > floor + 6.0, pw_db


def drone_acoustic_detect(audio, fs: float, blade_min_hz: float = 80.0,
                          blade_max_hz: float = 400.0, n_harm: int = 4):
    """Drone rotor-harmonic detection (drone_acoustic_detector.rs):
    harmonic product spectrum over the blade-pass band. Returns (freq,
    strength)."""
    a = _real(audio)
    n = a.shape[0]
    spec = complex_abs(torch.fft.rfft(a * _hanning(n, a.device))) ** 2
    hps = spec[: n // (2 * n_harm)]
    for k in range(2, n_harm + 1):
        hps = hps * spec[::k][: hps.shape[0]]
    freqs = np.fft.rfftfreq(n, 1.0 / fs)[: hps.shape[0]]
    band = torch.from_numpy((freqs >= blade_min_hz) & (freqs <= blade_max_hz)).to(a.device)
    hps_band = torch.where(band, hps, torch.zeros((), device=a.device))
    k = torch.argmax(hps_band)
    strength = hps_band[k] / torch.clamp(torch.mean(hps) + 1e-30, min=1e-30)
    return torch.from_numpy(freqs.astype(np.float32)).to(a.device)[k], strength


# -------------------------------------------------- vibration/rotating


def envelope_order_spectrum(vib, fs: float, rpm_track, n_orders: int = 10, max_revs: int = 512):
    """Order tracking (vibration_order_tracker.rs): vibration resampled to
    the shaft-angle domain on a fixed grid of max_revs × 64 samples, then
    |rFFT|; orders read at bins k·max_revs.

    The reference's three quirks are kept: the grid covers `max_revs`
    revolutions, so a longer track's later samples are dropped; the Hann
    window's length `n_valid` still counts every whole revolution of the
    track, so past max_revs the window is cut short; and the spectrum is
    divided by `n_valid`, not by the points summed. The shaft angle's
    cumulative sum accumulates in float64 and rounds once."""
    v = _real(vib)
    rpm = _real(to_tensor(rpm_track, device=v.device))
    revs = _cumsum(rpm / real_scalar(60.0, v.device)) / real_scalar(fs, v.device)
    spr = 64
    n_cap = max_revs * spr
    grid = torch.arange(n_cap, dtype=REAL_DTYPE, device=v.device) / real_scalar(spr, v.device)
    resampled = interp(grid, revs, v)
    n_valid = torch.clamp(torch.floor(revs[-1]), min=1.0) * spr
    i = torch.arange(n_cap, dtype=REAL_DTYPE, device=v.device)
    win = torch.where(i < n_valid, 0.5 - 0.5 * torch.cos(2.0 * torch.pi * i / n_valid),
                      torch.zeros((), device=v.device))
    spec = complex_abs(torch.fft.rfft(resampled * win)) / n_valid
    return spec[torch.arange(1, n_orders + 1, device=v.device) * max_revs]


def wheel_flat_detect(axle_vib, fs: float, wheel_circumference_m: float, speed_mps: float,
                      threshold: float = 8.0):
    """Railroad wheel-flat detection (railroad_wheel_flat_detector.rs): the
    envelope autocorrelation's peak near the wheel period as a robust
    z-score (median + MAD of the other lags). Returns (flat, score)."""
    v = _real(axle_vib)
    env = torch.abs(v)
    env = env - torch.mean(env)
    n = env.shape[0]
    f = torch.fft.rfft(env, 2 * n)
    ac = torch.fft.irfft(f * torch.conj(f), 2 * n)[:n]
    period = wheel_circumference_m / speed_mps
    lag = int(period * fs)
    if lag >= n or lag < 2:
        return (torch.zeros((), dtype=torch.bool, device=v.device),
                torch.zeros((), dtype=REAL_DTYPE, device=v.device))
    half = max(1, lag // 8)
    window = ac[max(1, lag - half): lag + half]
    med = median(ac[1:])
    mad = median(torch.abs(ac[1:] - med)) + 1e-12
    score = (torch.max(window) - med) / (1.4826 * mad)
    return score > threshold, score


def turbine_tip_timing(arrival_times_s, rpm: float, n_blades: int):
    """Blade-tip-timing deflection analysis (turbine_blade_tip_timing.rs):
    per-blade spread of the arrival jitter."""
    t = _real(arrival_times_s)
    period = 60.0 / rpm / n_blades
    n = t.shape[0]
    expected = t[0] + real_scalar(period, t.device) * torch.arange(n, dtype=REAL_DTYPE,
                                                                  device=t.device)
    jitter = t - expected
    n_rev = n // n_blades
    return _std(jitter[: n_rev * n_blades].reshape(n_rev, n_blades), dim=0)


def _analytic_mask(n: int, device=None):
    m = np.zeros(n)
    m[0] = 1.0
    m[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        m[n // 2] = 1.0
    return to_tensor(m.astype(np.complex64), device=device)


def bearing_health_bands(vib, fs: float, bpfo_hz: float, bpfi_hz: float):
    """Engine/wind-turbine bearing-band health
    (engine_vibration_signature_analyzer.rs /
    wind_turbine_vibration_monitor.rs): envelope-spectrum energy at the
    bearing defect frequencies against the background."""
    v = _real(vib)
    n = v.shape[0]
    analytic = torch.fft.ifft(torch.fft.fft(v.to(IQ_DTYPE)) * _analytic_mask(n, v.device))
    env = complex_abs(analytic)
    env = env - torch.mean(env)
    spec = complex_abs(torch.fft.rfft(env)) ** 2
    freqs = np.fft.rfftfreq(n, 1.0 / fs)

    def band_energy(f0):
        band = torch.from_numpy((freqs > f0 * 0.95) & (freqs < f0 * 1.05)).to(v.device)
        return torch.sum(torch.where(band, spec, torch.zeros((), device=v.device)))

    bg = median(spec) * n / real_scalar(20.0, v.device)
    return {"bpfo": band_energy(bpfo_hz) / bg, "bpfi": band_energy(bpfi_hz) / bg}


def structural_modal_shift(baseline, current, fs: float, n_modes: int = 3):
    """Structural-health modal-frequency shift (structural_health_monitor.rs):
    the relative shift of the dominant resonance frequencies."""
    def modes(x):
        x = _real(x)
        n = x.shape[0]
        spec = complex_abs(torch.fft.rfft(x * _hanning(n, x.device))) ** 2
        f = torch.from_numpy(np.fft.rfftfreq(n, 1.0 / fs).astype(np.float32)).to(x.device)
        bins = torch.arange(spec.shape[0], device=x.device)
        picked = []
        s = spec
        for _ in range(n_modes):
            k = torch.argmax(s)
            picked.append(f[k])
            s = torch.where(torch.abs(bins - k) < 5, torch.zeros((), device=x.device), s)
        return torch.sort(torch.stack(picked)).values

    f0 = modes(baseline)
    f1 = modes(current)
    return (f1 - f0) / torch.clamp(f0, min=1e-9)


def dam_seepage_score(hydrophone, fs: float, band=(500.0, 2000.0)):
    """Seepage-noise band-energy fraction (dam_seepage_monitor.rs /
    reservoir_acoustic_monitor.rs)."""
    x = _real(hydrophone)
    spec = complex_abs(torch.fft.rfft(x)) ** 2
    f = np.fft.rfftfreq(x.shape[0], 1.0 / fs)
    sel = torch.from_numpy((f >= band[0]) & (f <= band[1])).to(x.device)
    return torch.sum(torch.where(sel, spec, torch.zeros((), device=x.device))) / torch.sum(spec)


# ---------------------------------------------------------- seismic


def sta_lta(x, n_sta: int, n_lta: int):
    """Short-term/long-term average ratio (seismic_arrival_detector.rs):
    two moving averages as differences of one cumulative sum, accumulated
    in float64 and rounded once."""
    a = torch.abs(_real(x))
    c = _cumsum(torch.cat([torch.zeros(a.shape[:-1] + (1,), dtype=REAL_DTYPE, device=a.device),
                           a], dim=-1))
    sta = (c[..., n_sta:] - c[..., :-n_sta]) / real_scalar(float(n_sta), a.device)
    lta = (c[..., n_lta:] - c[..., :-n_lta]) / real_scalar(float(n_lta), a.device)
    m = min(sta.shape[-1], lta.shape[-1])
    return sta[..., -m:] / torch.clamp(lta[..., -m:], min=1e-12)


def seismic_pick(x, fs: float, n_sta_s: float = 0.5, n_lta_s: float = 5.0,
                 threshold: float = 3.0):
    """First-arrival pick time (seismic_processor.rs); NaN when nothing
    crosses."""
    r = sta_lta(x, int(n_sta_s * fs), int(n_lta_s * fs))
    above = r > threshold
    found = torch.any(above)
    first = torch.argmax(above.to(torch.int32))
    off = to_tensor(x).shape[-1] - r.shape[0]
    t = (first + off).to(REAL_DTYPE) / real_scalar(fs, r.device)
    return torch.where(found, t, torch.full((), torch.nan, device=r.device))


def seismic_classify(x, fs: float):
    """Quake/blast/noise classification (seismograph_event_classifier.rs):
    spectral centroid + envelope decay rate features, numpy as the
    reference."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, float)
    spec = np.abs(np.fft.rfft(a * np.hanning(a.shape[0]))) ** 2
    f = np.fft.rfftfreq(a.shape[0], 1.0 / fs)
    centroid = float(np.sum(f * spec) / max(np.sum(spec), 1e-12))
    env = np.abs(a)
    peak = env.argmax()
    tail = env[peak:]
    if tail.shape[0] < 10 or env.max() < 8 * np.median(env):
        return "noise"
    decay = np.polyfit(np.arange(tail.shape[0]), np.log(np.maximum(tail, 1e-9)), 1)[0]
    if centroid > 20.0 and decay < -2e-3:
        return "blast"
    return "earthquake"


# ----------------------------------------------- space weather / EM


def _frame_rows(p: torch.Tensor, frame: int) -> torch.Tensor:
    n = (p.shape[-1] // frame) * frame
    return p[..., :n].reshape(*p.shape[:-1], -1, frame)


def scintillation_s4(power, frame: int = 50):
    """S4 amplitude-scintillation index (ionospheric_scintillation_detector.rs):
    per-frame sqrt((<P²>-<P>²)/<P>²)."""
    frames = _frame_rows(_real(power), frame)
    m1 = torch.mean(frames, dim=-1)
    m2 = torch.mean(frames ** 2, dim=-1)
    return torch.sqrt(torch.clamp(m2 - m1 ** 2, min=0.0) / torch.clamp(m1 ** 2, min=1e-30))


def scintillation_sigma_phi(phase, frame: int = 50):
    """σ_φ phase-scintillation index (ionospheric_scintillation_analyzer.rs):
    the std of each frame's linearly detrended phase."""
    frames = _frame_rows(_real(phase), frame)
    t = torch.arange(frame, dtype=REAL_DTYPE, device=frames.device)
    t_c = t - torch.mean(t)
    denom = torch.sum(t_c * t_c)
    slope = frames @ t_c / denom
    resid = (frames - torch.mean(frames, dim=-1, keepdim=True) - slope[..., None] * t_c)
    return _std(resid, dim=-1)


def geomagnetic_storm_index(bfield_nt, fs: float, window_s: float = 60.0):
    """Storm-activity index from magnetometer data
    (geomagnetic_storm_detector.rs): per-window range as a K-like index +
    the disturbance flag."""
    frames = _frame_rows(_real(bfield_nt), int(window_s * fs))
    rng = torch.amax(frames, dim=-1) - torch.amin(frames, dim=-1)
    k_like = torch.log2(1.0 + rng / real_scalar(5.0, frames.device))
    return k_like, torch.max(k_like) > 5


def magnetic_anomaly_detect(total_field_nt, baseline_window: int = 256,
                            threshold_nt: float = 5.0):
    """MAD dipole-anomaly detection (magnetic_anomaly_detector.rs):
    high-pass against a running median (centred window, edges
    replicated)."""
    b = _real(total_field_nt)
    w = baseline_window
    half = w // 2
    padded = torch.cat([b[:1].expand(half), b, b[-1:].expand(w - half - 1)])
    base = median(padded.unfold(0, w, 1), dim=-1)
    resid = b - base
    return torch.abs(resid) > threshold_nt, resid


def gravity_gradient_tensor(gz_grid, spacing_m: float):
    """Gravity-gradient components from a gz map
    (gravity_gradiometer_processor.rs): finite-difference Tzx, Tzy."""
    g = _real(gz_grid)
    two_h = real_scalar(2.0 * spacing_m, g.device)
    return (g[:, 2:] - g[:, :-2]) / two_h, (g[2:, :] - g[:-2, :]) / two_h


def lightning_stroke_analyze(efield, fs: float, threshold_sigma: float = 6.0,
                             max_strokes: int = 64):
    """Stroke detection + polarity + rise time (lightning_stroke_analyzer.rs):
    `(times_s[K], polarities[K], rise_times_s[K], valid[K])` for K =
    max_strokes; the refractory state machine is the port's
    `events.refractory_trigger`."""
    from r4w_tpu_torch.ops.events import masked_indices, refractory_trigger

    e = _real(efield)
    sd = _std(e)
    w = max(1, int(2e-3 * fs))
    fires_m = refractory_trigger(torch.abs(e) > threshold_sigma * sd, w)
    fires, valid = masked_indices(fires_m, max_strokes)
    pad = torch.cat([e, torch.zeros(w + 1, dtype=REAL_DTYPE, device=e.device)])
    segs = pad[fires.long()[:, None] + torch.arange(w, device=e.device)[None, :]]
    peaks = torch.argmax(torch.abs(segs), dim=1)
    pols = torch.where(segs[torch.arange(max_strokes, device=e.device), peaks] > 0, 1, -1)
    fs_t = real_scalar(fs, e.device)
    return (fires.to(REAL_DTYPE) / fs_t,
            torch.where(valid, pols, 0).to(torch.int32), peaks.to(REAL_DTYPE) / fs_t, valid)


def cosmic_ray_coincidence(det_a, det_b, threshold_sigma: float = 5.0, window: int = 3):
    """Two-detector coincidence counting (cosmic_ray_detector.rs)."""
    def hits(x):
        a = torch.abs(_real(x))
        return a > threshold_sigma * median(a) * 1.4826

    ha = hits(det_a)
    hb = hits(to_tensor(det_b, device=ha.device))
    near_b = F.max_pool1d(F.pad(hb.to(REAL_DTYPE)[None, None], (window, window)),
                          2 * window + 1, stride=1)[0, 0] > 0
    return torch.sum(ha & near_b[: ha.shape[0]], dtype=torch.int32)


# ------------------------------------------------- photonics / nuclear


def fbg_wavelength_shift(spectrum, wavelengths_nm):
    """Fiber-Bragg-grating peak interrogation
    (fiber_bragg_grating_interrogator.rs): the centroid wavelength of the 7
    samples from the peak − 3, the start clamped so that they fit."""
    s = _real(spectrum)
    w = _real(to_tensor(wavelengths_nm, device=s.device))
    k = torch.argmax(s)
    lo = torch.clamp(torch.clamp(k - 3, min=0), max=s.shape[0] - 7)
    idx = lo + torch.arange(7, device=s.device)
    win, wl = s[idx], w[idx]
    return torch.sum(win * wl) / torch.clamp(torch.sum(win), min=1e-12)


def oct_a_scan(interferogram, n_fft: int | None = None):
    """Spectral-domain OCT depth profile (optical_coherence_tomography.rs):
    |IFFT| of the k-space interferogram after DC removal."""
    x = _real(interferogram)
    x = x - torch.mean(x)
    n = n_fft or x.shape[0]
    return complex_abs(torch.fft.ifft(x.to(IQ_DTYPE), n))[: n // 2]


def photoacoustic_reconstruct(sensor_data, sensor_pos_m, pixel_grid_m, c: float = 1500.0,
                              fs: float = 20e6):
    """Delay-and-sum photoacoustic reconstruction
    (photoacoustic_image_reconstructor.rs): one-way travel time; the
    distances' roots taken in float64 and rounded (an index truncates
    them)."""
    data = _real(sensor_data)
    pos = _real(to_tensor(sensor_pos_m, device=data.device))
    px = _real(to_tensor(pixel_grid_m, device=data.device))
    d2 = torch.sum((pos[:, None, :] - px[None, :, :]) ** 2, dim=-1)
    d = torch.sqrt(d2.double()).to(REAL_DTYPE)
    idx = torch.clamp((d / real_scalar(c, d.device) * fs).to(torch.int32), 0,
                      data.shape[-1] - 1)
    return torch.sum(torch.gather(data, -1, idx.long()), dim=0)


def mrs_quantify(fid, fs: float, metabolite_hz):
    """MR-spectroscopy metabolite quantification
    (mr_spectroscopy_processor.rs): apodized FFT of the FID, 7-bin peak
    integrals at the known chemical shifts (each window's start clamped so
    that it fits)."""
    x = to_tensor(fid, IQ_DTYPE)
    n = x.shape[0]
    apod = torch.exp(-3.0 * torch.arange(n, dtype=REAL_DTYPE, device=x.device)
                     / real_scalar(float(n), x.device))
    spec = complex_abs(torch.fft.fftshift(torch.fft.fft(x * apod)))
    freqs = np.fft.fftshift(np.fft.fftfreq(n, 1.0 / fs))
    if isinstance(metabolite_hz, torch.Tensor):
        metabolite_hz = metabolite_hz.cpu().numpy()
    out = []
    for f0 in metabolite_hz:
        k = int(np.argmin(np.abs(freqs - f0)))
        lo = min(max(k - 3, 0), n - 7)
        out.append(torch.sum(spec[lo:lo + 7]))
    return torch.stack(out)


def _histogram(v: torch.Tensor, n_bins: int, e_max: float) -> torch.Tensor:
    """``jnp.histogram(v, n_bins, (0, e_max))[0]`` as float32 counts: the
    bin of each value is searchsorted (right) in the float32 edges, the last
    edge itself falls in the last bin, values outside are dropped."""
    edges = linspace(0.0, e_max, n_bins + 1, v.device)
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], n_bins, idx)
    inside = (idx >= 1) & (idx <= n_bins)
    counts = torch.bincount(torch.where(inside, idx, 0), minlength=n_bins + 1)
    return counts[1:n_bins + 1].to(REAL_DTYPE)


def gamma_spectrum(pulse_heights, n_bins: int = 256, e_max: float = 3000.0):
    """Pulse-height histogram + peak find (nuclear_spectroscopy_analyzer.rs /
    radiation_detector_processor.rs). Returns (histogram, peak energies
    keV: NaN where no local maximum of the 5-bin average stands above 3×
    its median floor)."""
    h = _histogram(_real(pulse_heights), n_bins, e_max)
    box = torch.full((5,), 1.0 / 5.0, dtype=REAL_DTYPE, device=h.device)
    # the 5-term window sums of exact products, rounded once
    padded = F.pad(h.double(), (2, 2))
    sm = torch.sum(padded.unfold(0, 5, 1) * box.double(), dim=-1).to(REAL_DTYPE)
    is_peak = ((sm[2:-2] > sm[1:-3]) & (sm[2:-2] >= sm[3:-1])
               & (sm[2:-2] > 3.0 * median(sm + 1.0)))
    is_peak = F.pad(is_peak, (2, 2))
    centers = ((torch.arange(n_bins, dtype=REAL_DTYPE, device=h.device) + 0.5) * e_max
               / real_scalar(float(n_bins), h.device))
    return h, torch.where(is_peak, centers, torch.full((), torch.nan, device=h.device))


def bpm_position(electrode_signals):
    """Beam-position-monitor difference-over-sum (particle_accelerator_bpm.rs):
    (x, y) from 4 button electrodes (A=+x+y, B=-x+y, C=-x-y, D=+x-y)."""
    first = _real(electrode_signals[0])
    a, b, c, d = [_real(to_tensor(s, device=first.device)) for s in electrode_signals]
    tot = torch.clamp(a + b + c + d, min=1e-12)
    return ((a + d) - (b + c)) / tot, ((a + b) - (c + d)) / tot


def langmuir_analyze(voltage, current):
    """Langmuir-probe plasma parameters (plasma_diagnostics_processor.rs):
    floating potential at the first sign change of I, electron temperature
    from the masked log-linear slope of the electron current."""
    v = _real(voltage)
    i = _real(to_tensor(current, device=v.device))
    cross = torch.diff(torch.sign(i)) != 0
    nan = torch.full((), torch.nan, device=v.device)
    v_f = torch.where(torch.any(cross), v[torch.argmax(cross.to(torch.int32))], nan)
    i_e = i - torch.min(i)
    peak = torch.max(i_e)
    sel = ((i_e > torch.clamp(peak * 0.02, min=1e-12)) & (i_e < peak * 0.5)).to(REAL_DTYPE)
    n_sel = torch.sum(sel)
    y = torch.log(torch.clamp(i_e, min=1e-30))
    vm = torch.sum(sel * v) / torch.clamp(n_sel, min=1.0)
    ym = torch.sum(sel * y) / torch.clamp(n_sel, min=1.0)
    slope = (torch.sum(sel * (v - vm) * (y - ym))
             / torch.clamp(torch.sum(sel * (v - vm) ** 2), min=1e-30))
    te_ev = torch.where((n_sel >= 3) & (slope > 0), 1.0 / slope, nan)
    return {"v_float": v_f, "te_ev": te_ev}


def plasma_impedance(v_wave, i_wave):
    """Complex RF impedance from V/I waveforms (plasma_impedance_analyzer.rs):
    fundamental-phasor ratio."""
    v = _real(v_wave)
    i = _real(to_tensor(i_wave, device=v.device))
    vf = torch.fft.rfft(v)
    if_ = torch.fft.rfft(i)
    k = torch.argmax(complex_abs(vf[1:])) + 1
    return vf[k] / if_[k]


def hyperspectral_unmix(cube, endmembers, n_iter: int = 200):
    """Non-negative abundance unmixing (hyperspectral_spectral_unmixing.rs):
    projected-gradient NNLS per pixel, a step loop of float32 matrix
    products, the step 1/λmax of the endmembers' Gram matrix."""
    y = _real(cube)
    e = _real(to_tensor(endmembers, device=y.device))
    g = e @ e.T
    lr = 1.0 / torch.max(torch.linalg.eigvalsh(g))
    a = torch.full((y.shape[0], e.shape[0]), 1.0 / e.shape[0], dtype=REAL_DTYPE, device=y.device)
    ye = y @ e.T
    for _ in range(n_iter):
        a = torch.clamp(a - lr * (a @ g - ye), min=0.0)
    return a


def soil_moisture_permittivity(reflection_coef):
    """Soil permittivity → volumetric moisture (Topp equation)
    (precision_ag_soil_sensor.rs). Returns (theta, eps)."""
    g = torch.abs(_real(reflection_coef))
    r = (1.0 + g) / torch.clamp(1.0 - g, min=1e-6)
    eps = r * r
    eps2 = eps * eps
    theta = -5.3e-2 + 2.92e-2 * eps - 5.5e-4 * eps2 + 4.3e-6 * (eps2 * eps)
    return torch.clamp(theta, 0.0, 0.6), eps


def spo2_ratio(red_ac, red_dc, ir_ac, ir_dc):
    """Ratio-of-ratios SpO2 estimate (pulse_oximeter_processor.rs): the
    standard empirical calibration SpO2 = 110 - 25·R. Returns (SpO2, R)."""
    red = _real(red_ac)

    def div(a, b):
        return a / (real_scalar(b, a.device) if isinstance(b, (int, float)) else
                    _real(to_tensor(b, device=a.device)))
    r = div(red, red_dc) / div(_real(to_tensor(ir_ac, device=red.device)), ir_dc)
    return torch.clamp(110.0 - 25.0 * r, 0.0, 100.0), r


def tidal_harmonic_fit(heights_m, t_hours, constituents_hr=(12.42, 12.00, 25.82, 23.93)):
    """Tidal harmonic analysis (tidal_harmonic_analyzer.rs): least-squares
    fit of the M2/S2/O1/K1 constituents by the reference's float32 normal
    equations (ill-conditioned; no decision hangs on them). Returns
    (amplitudes, phases, mean)."""
    h = _real(heights_m)
    t = _real(to_tensor(t_hours, device=h.device))
    cols = [torch.ones_like(t)]
    for period in constituents_hr:
        w = real_scalar(2 * np.pi / period, t.device)
        cols += [torch.cos(w * t), torch.sin(w * t)]
    a_mat = torch.stack(cols, dim=-1)
    coef = torch.linalg.solve(a_mat.T @ a_mat, a_mat.T @ h)
    c, s = coef[1::2], coef[2::2]
    return torch.hypot(c, s), torch.atan2(s, c), coef[0]


BLOCKS = {
    "acoustic_emission_sensor": ("acoustic_emission_count",
                                 "measurement",
                                 "AE hit counting "
                                 "(acoustic_emission_sensor.rs)",
                                 ("threshold_sigma",)),
    "acoustic_gunshot_localizer": ("gunshot_localize", "measurement",
                                   "GCC-PHAT TDOA position "
                                   "(acoustic_gunshot_localizer.rs)",
                                   ("fs", "c")),
    "acoustic_impedance_tomographer": (
        "impedance_tomography_backproject", "measurement",
        "filtered backprojection "
        "(acoustic_impedance_tomographer.rs)", ("n_px",)),
    "acoustic_leak_locator": ("leak_locate", "measurement",
                              "two-sensor xcorr leak position "
                              "(acoustic_leak_locator.rs)",
                              ("distance_m", "fs")),
    "avalanche_transceiver_correlator": (
        "avalanche_beacon_search", "measurement",
        "457 kHz pulse search "
        "(avalanche_transceiver_correlator.rs)", ("fs",)),
    "drone_acoustic_detector": ("drone_acoustic_detect", "measurement",
                                "rotor harmonic-product spectrum "
                                "(drone_acoustic_detector.rs)",
                                ("fs",)),
    "vibration_order_tracker": ("envelope_order_spectrum",
                                "measurement",
                                "angle-domain order spectrum "
                                "(vibration_order_tracker.rs)",
                                ("fs", "n_orders")),
    "railroad_wheel_flat_detector": ("wheel_flat_detect",
                                     "measurement",
                                     "rotation-period impact detect "
                                     "(railroad_wheel_flat_"
                                     "detector.rs)", ("fs",)),
    "turbine_blade_tip_timing": ("turbine_tip_timing", "measurement",
                                 "per-blade arrival jitter "
                                 "(turbine_blade_tip_timing.rs)",
                                 ("rpm", "n_blades")),
    "engine_vibration_signature": ("bearing_health_bands",
                                   "measurement",
                                   "bearing defect band energy "
                                   "(engine_vibration_signature_"
                                   "analyzer.rs)",
                                   ("fs", "bpfo_hz", "bpfi_hz")),
    "wind_turbine_vibration_monitor": (
        "bearing_health_bands", "measurement",
        "drivetrain band health "
        "(wind_turbine_vibration_monitor.rs)"),
    "structural_health_monitor": ("structural_modal_shift",
                                  "measurement",
                                  "modal frequency shift "
                                  "(structural_health_monitor.rs)",
                                  ("fs", "n_modes")),
    "dam_seepage_monitor": ("dam_seepage_score", "measurement",
                            "seepage band-energy fraction "
                            "(dam_seepage_monitor.rs / "
                            "reservoir_acoustic_monitor.rs)", ("fs",)),
    "seismic_arrival_detector": ("sta_lta", "measurement",
                                 "STA/LTA picker "
                                 "(seismic_arrival_detector.rs)",
                                 ("n_sta", "n_lta")),
    "seismic_processor": ("seismic_pick", "measurement",
                          "first-arrival pick (seismic_processor.rs)",
                          ("fs", "threshold")),
    "seismograph_event_classifier": ("seismic_classify", "measurement",
                                     "quake/blast/noise "
                                     "(seismograph_event_"
                                     "classifier.rs)", ("fs",)),
    "ionospheric_scintillation_detector": (
        "scintillation_s4", "gnss",
        "S4 index (ionospheric_scintillation_detector.rs)",
        ("frame",)),
    "ionospheric_scintillation_analyzer": (
        "scintillation_sigma_phi", "gnss",
        "sigma-phi index (ionospheric_scintillation_analyzer.rs)",
        ("frame",)),
    "geomagnetic_storm_detector": ("geomagnetic_storm_index",
                                   "measurement",
                                   "K-like range index "
                                   "(geomagnetic_storm_detector.rs)",
                                   ("fs", "window_s")),
    "magnetic_anomaly_detector": ("magnetic_anomaly_detect",
                                  "measurement",
                                  "median-baseline MAD "
                                  "(magnetic_anomaly_detector.rs)",
                                  ("threshold_nt",)),
    "gravity_gradiometer_processor": ("gravity_gradient_tensor",
                                      "measurement",
                                      "finite-difference gradients "
                                      "(gravity_gradiometer_"
                                      "processor.rs)", ("spacing_m",)),
    "lightning_stroke_analyzer": ("lightning_stroke_analyze",
                                  "measurement",
                                  "stroke polarity + rise time "
                                  "(lightning_stroke_analyzer.rs)",
                                  ("fs",)),
    "cosmic_ray_detector": ("cosmic_ray_coincidence", "measurement",
                            "two-detector coincidences "
                            "(cosmic_ray_detector.rs)", ("window",)),
    "fiber_bragg_interrogator": ("fbg_wavelength_shift", "measurement",
                                 "centroid peak wavelength "
                                 "(fiber_bragg_grating_"
                                 "interrogator.rs)"),
    "optical_coherence_tomography": ("oct_a_scan", "measurement",
                                     "SD-OCT A-scan "
                                     "(optical_coherence_"
                                     "tomography.rs)"),
    "photoacoustic_reconstructor": ("photoacoustic_reconstruct",
                                    "measurement",
                                    "delay-and-sum PA imaging "
                                    "(photoacoustic_image_"
                                    "reconstructor.rs)", ("c", "fs")),
    "mr_spectroscopy_processor": ("mrs_quantify", "measurement",
                                  "metabolite peak integrals "
                                  "(mr_spectroscopy_processor.rs)",
                                  ("fs",)),
    "nuclear_spectroscopy_analyzer": ("gamma_spectrum", "measurement",
                                      "pulse-height histogram+peaks "
                                      "(nuclear_spectroscopy_"
                                      "analyzer.rs)", ("n_bins",)),
    "particle_accelerator_bpm": ("bpm_position", "measurement",
                                 "difference-over-sum beam position "
                                 "(particle_accelerator_bpm.rs)"),
    "plasma_diagnostics_processor": ("langmuir_analyze", "measurement",
                                     "Langmuir Te + Vfloat "
                                     "(plasma_diagnostics_"
                                     "processor.rs)"),
    "plasma_impedance_analyzer": ("plasma_impedance", "measurement",
                                  "fundamental V/I impedance "
                                  "(plasma_impedance_analyzer.rs)"),
    "hyperspectral_unmixing": ("hyperspectral_unmix", "math",
                               "batched NNLS abundances "
                               "(hyperspectral_spectral_"
                               "unmixing.rs)", ("n_iter",)),
    "precision_ag_soil_sensor": ("soil_moisture_permittivity",
                                 "measurement",
                                 "Topp-equation moisture "
                                 "(precision_ag_soil_sensor.rs)"),
    "pulse_oximeter_processor": ("spo2_ratio", "measurement",
                                 "ratio-of-ratios SpO2 "
                                 "(pulse_oximeter_processor.rs)"),
    "tidal_harmonic_analyzer": ("tidal_harmonic_fit", "measurement",
                                "M2/S2/O1/K1 LS fit "
                                "(tidal_harmonic_analyzer.rs)"),
}
