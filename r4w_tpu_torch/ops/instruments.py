"""Instrument / EMC / direction-finding / fingerprinting fills.

PyTorch counterpart of ``r4w_tpu.ops.instruments`` (network_analyzer.rs,
oscilloscope_trigger.rs, jitter_analyzer.rs, power_meter.rs,
rf_power_monitor.rs, vector_signal_analyzer.rs, rf_impedance_tuner.rs,
transmission_line_simulator.rs, rf_circuit_em_simulator.rs,
antenna_design_optimizer.rs, rf_impairment_calibrator.rs,
passive_intermod_analyzer.rs, emi_conducted_analyzer.rs,
emc_radiated_immunity.rs, injection_locking_detector.rs,
spurious_emission_scanner.rs, spurs_mitigation.rs,
direction_finding_watson_watt.rs, radio_direction_finder.rs,
rdf_network_triangulator.rs, gps_spoofing_detector.rs,
modulation_fingerprinter.rs, modulation_recognition_classifier.rs,
rf_fingerprinting_engine.rs, rf_environment_mapper.rs,
protocol_anomaly_detector.rs, radio_astronomy_receiver.rs,
radio_telescope_correlator.rs).

The RF circuit formulas, the PIM product list and the spoofing heuristics
are the reference's numpy. `spur_scan` ranks by a stable descending sort
(ties keep the lower bin first, as ``lax.top_k``); `oscilloscope_trigger`
runs on the port's `events.refractory_trigger` and
`events.masked_indices`; `vector_signal_analyze` and
`df_bearing_pseudodoppler` on the port's `mapping`, `measure` and
`modem`. `triangulate_bearings` solves its 2 × 2 normal equations in
float32 as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs, linspace, magnitude
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops.spectral2 import _device, _frames, _real, _std

# -------------------------------------------------------- instruments


def _angle(z: torch.Tensor) -> torch.Tensor:
    return torch.atan2(z.imag, z.real)


def network_analyzer_s21(stimulus, response, n_fft: int | None = None):
    """Transfer-function measurement (network_analyzer.rs):
    S21(f) = FFT(response)/FFT(stimulus), magnitude dB + phase."""
    a = to_tensor(stimulus, IQ_DTYPE)
    b = to_tensor(response, IQ_DTYPE, device=a.device)
    n = n_fft or a.shape[-1]
    fa = torch.fft.fft(a, n)
    fb = torch.fft.fft(b, n)
    h = fb * torch.conj(fa) / (complex_abs(fa) ** 2 + 1e-12)
    return 20.0 * torch.log10(torch.clamp(complex_abs(h), min=1e-12)), _angle(h)


def oscilloscope_trigger(x, level: float, slope: str = "rising", holdoff: int = 16,
                         pre: int = 8, length: int = 64, max_captures: int = 16):
    """Edge-trigger capture (oscilloscope_trigger.rs): `(indices[K] int32,
    frames[K, length], valid[K])` for K = max_captures, the holdoff on
    `events.refractory_trigger` and the captures one padded gather."""
    from r4w_tpu_torch.ops.events import masked_indices, refractory_trigger

    a = to_tensor(x)
    if a.dtype == torch.float64:
        a = a.to(REAL_DTYPE)
    n = a.shape[0]
    if slope == "rising":
        cross = (a[:-1] < level) & (a[1:] >= level)
    else:
        cross = (a[:-1] > level) & (a[1:] <= level)
    acc = refractory_trigger(cross, holdoff)
    i = torch.arange(n - 1, device=a.device)
    acc = acc & (i - pre >= 0) & (i - pre + length <= n)
    idx, valid = masked_indices(acc, max_captures)
    pad = torch.cat([a, torch.zeros(length + 1, dtype=a.dtype, device=a.device)])
    frames = pad[(idx.long() - pre)[:, None] + torch.arange(length, device=a.device)[None, :]]
    frames = torch.where(valid[:, None], frames, torch.zeros((), dtype=a.dtype, device=a.device))
    return idx, frames, valid


def jitter_analyze(edges_s, nominal_period_s: float):
    """Time-interval-error jitter metrics (jitter_analyzer.rs): TIE series,
    RMS + peak-to-peak jitter, period jitter."""
    e = to_tensor(edges_s, REAL_DTYPE)
    n = e.shape[0]
    expected = e[0] + real_scalar(nominal_period_s, e.device) * torch.arange(
        n, dtype=REAL_DTYPE, device=e.device)
    tie = e - expected
    periods = torch.diff(e)
    return {"tie_rms_s": _std(tie), "tie_pp_s": torch.max(tie) - torch.min(tie),
            "period_jitter_rms_s": _std(periods), "tie": tie}


def power_meter_dbm(x, impedance_ohm: float = 50.0, full_scale_v: float = 1.0):
    """Average + peak power in dBm (power_meter.rs / rf_power_monitor.rs)."""
    x = to_tensor(x)
    if x.dtype == torch.float64:
        x = x.to(REAL_DTYPE)
    v = magnitude(x) * full_scale_v
    two_r = real_scalar(2.0 * impedance_ohm, v.device)
    p_avg_w = torch.mean(v ** 2, dim=-1) / two_r
    p_pk_w = torch.amax(v ** 2, dim=-1) / two_r

    def to_dbm(p):
        return 10.0 * torch.log10(torch.clamp(p, min=1e-15)) + 30.0
    return to_dbm(p_avg_w), to_dbm(p_pk_w)


def vector_signal_analyze(x, constellation, sps: int = 1):
    """Composite VSA report (vector_signal_analyzer.rs): EVM, decision
    margin, magnitude/phase error, PAPR and an M2M4 SNR, on the port's
    measurement ops."""
    from r4w_tpu_torch.ops import mapping as _mapping
    from r4w_tpu_torch.ops import measure as _measure
    from r4w_tpu_torch.ops import modem as _modem
    x = to_tensor(x, IQ_DTYPE)
    syms = x[::sps]
    idx, evm, margin = _mapping.constellation_receiver(syms, constellation)
    table = to_tensor(constellation, IQ_DTYPE, device=x.device)
    ref = table[idx.long()]
    mag_err = torch.mean(torch.abs(complex_abs(syms) - complex_abs(ref)))
    ph_err = torch.mean(torch.abs(_angle(syms * torch.conj(ref))))
    return {"evm_rms": evm, "decision_margin": margin, "mag_error": mag_err,
            "phase_error_rad": ph_err, "papr_db": _modem.papr_db(x),
            "snr_est_db": _measure.snr_estimate_m2m4(syms)}


# ------------------------------------------------------ RF circuits


def transmission_line_input_impedance(z_load, z0: float, beta_l_rad: float):
    """Lossless line impedance transform (transmission_line_simulator.rs):
    Zin = Z0 (ZL + jZ0 tanβl)/(Z0 + jZL tanβl)."""
    zl = complex(z_load)
    t = np.tan(beta_l_rad)
    return z0 * (zl + 1j * z0 * t) / (z0 + 1j * zl * t)


def reflection_coefficient(z, z0: float = 50.0):
    z = np.asarray(z, complex)
    return (z - z0) / (z + z0)


def vswr(z, z0: float = 50.0):
    g = np.abs(reflection_coefficient(z, z0))
    return (1.0 + g) / np.maximum(1.0 - g, 1e-9)


def stub_match(z_load, z0: float = 50.0, n_grid: int = 400):
    """Single-stub matching search (rf_impedance_tuner.rs): grid over stub
    position/length minimizing |Γ|. Returns (d_frac, l_frac,
    residual_vswr) in wavelengths."""
    best = (0.0, 0.0, np.inf)
    for d in np.linspace(0.01, 0.49, n_grid // 20):
        zin = transmission_line_input_impedance(z_load, z0, 2 * np.pi * d)
        yin = 1.0 / zin
        for length in np.linspace(0.01, 0.49, n_grid // 20):
            y_stub = -1j / (z0 * np.tan(2 * np.pi * length))  # shorted stub
            y_tot = yin + y_stub
            s = float(vswr(1.0 / y_tot, z0))
            if s < best[2]:
                best = (d, length, s)
    return best


def microstrip_impedance(w_over_h: float, eps_r: float = 4.4):
    """Closed-form microstrip Z0 (rf_circuit_em_simulator.rs —
    Hammerstad)."""
    u = w_over_h
    eps_eff = (eps_r + 1) / 2 + (eps_r - 1) / 2 / np.sqrt(1 + 12.0 / u)
    if u < 1:
        z0 = 60.0 / np.sqrt(eps_eff) * np.log(8.0 / u + u / 4.0)
    else:
        z0 = 120.0 * np.pi / (np.sqrt(eps_eff) * (u + 1.393 + 0.667 * np.log(u + 1.444)))
    return z0, eps_eff


def dipole_optimize(freq_hz: float, n_grid: int = 200):
    """Half-wave dipole length tuning (antenna_design_optimizer.rs): sweep
    length around λ/2 minimizing |X_in| with the classic induced-EMF
    reactance fit X ≈ 43·(L/λ - 0.468)/0.01 Ω."""
    lam = 299_792_458.0 / freq_hz
    lengths = np.linspace(0.40, 0.52, n_grid) * lam
    react = 43.0 * (lengths / lam - 0.468) / 0.01 * 0.01 * 100
    k = int(np.argmin(np.abs(react)))
    return float(lengths[k]), float(lengths[k] / lam)


def iq_impairment_calibrate(x):
    """Blind IQ gain/phase imbalance estimation + correction
    (rf_impairment_calibrator.rs): from E[I²]/E[Q²] and E[IQ]."""
    z = to_tensor(x, IQ_DTYPE)
    i, q = z.real, z.imag
    mii, mqq = torch.mean(i * i, dim=-1), torch.mean(q * q, dim=-1)
    gain = torch.sqrt(mii / torch.clamp(mqq, min=1e-12))
    phase = torch.mean(i * q, dim=-1) / torch.clamp(torch.sqrt(mii * mqq), min=1e-12)
    q_c = (q * gain[..., None] + i * (-phase)[..., None]) / torch.sqrt(
        1 - phase ** 2)[..., None]
    return torch.complex(i, q_c), {"gain": gain, "phase_sin": phase}


# --------------------------------------------------------- EMC / PIM


def pim_products(f1_hz: float, f2_hz: float, order: int = 3):
    """Passive-intermod product frequencies (passive_intermod_analyzer.rs):
    |m·f1 ± n·f2| with m+n = order."""
    out = []
    for m in range(order + 1):
        n = order - m
        if m and n:
            out += [abs(m * f1_hz - n * f2_hz), m * f1_hz + n * f2_hz]
    return sorted(set(out))


def _hann_power(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    w = torch.from_numpy(np.hanning(n).astype(np.float32)).to(x.device)
    return complex_abs(torch.fft.fft(x * w)) ** 2


def pim_level(x, f1_hz: float, f2_hz: float, sample_rate: float, order: int = 3):
    """The worst IM product level around the predicted products, dBc
    (passive_intermod_analyzer.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    spec = _hann_power(x)
    freqs = np.fft.fftfreq(n, 1.0 / sample_rate)
    worst = torch.full((), -torch.inf, dtype=REAL_DTYPE, device=x.device)
    for f in pim_products(f1_hz, f2_hz, order):
        for sgn in (f, -f):
            k = int(np.argmin(np.abs(freqs - sgn)))
            worst = torch.maximum(worst, 10.0 * torch.log10(torch.clamp(spec[k], min=1e-30)))
    carrier = 10.0 * torch.log10(torch.clamp(
        spec[int(np.argmin(np.abs(freqs - f1_hz)))], min=1e-30))
    return worst - carrier


def emi_conducted_scan(x, sample_rate: float, rbw_hz: float = 9e3):
    """CISPR-style conducted-emission scan (emi_conducted_analyzer.rs):
    peak-hold and mean per bin over frames at the given RBW."""
    x = _real(x)
    n_fft = max(64, int(sample_rate / rbw_hz))
    spec = complex_abs(torch.fft.rfft(_frames(x, n_fft), dim=-1))
    qp = torch.amax(spec, dim=-2)
    avg = torch.mean(spec, dim=-2)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    return torch.from_numpy(freqs.astype(np.float32)).to(x.device), qp, avg


def immunity_test_levels(freq_hz, field_v_per_m: float = 3.0):
    """IEC 61000-4-3 style immunity test profile
    (emc_radiated_immunity.rs): required field over the sweep with the 80%
    AM factor, on `freq_hz`'s device when it is a tensor."""
    device = _device(freq_hz)
    if isinstance(freq_hz, torch.Tensor):
        freq_hz = freq_hz.cpu().numpy()
    f = np.atleast_1d(np.asarray(freq_hz, float))
    peak = field_v_per_m * 1.8
    return to_tensor(np.full(f.shape, peak, np.float32), device=device)


def injection_locking_detect(x, sample_rate: float, f_free_hz: float, tol_hz: float = 2.0):
    """Detect oscillator injection locking (injection_locking_detector.rs):
    the instantaneous frequency collapses onto the injected tone."""
    x = to_tensor(x, IQ_DTYPE)
    d = x[..., 1:] * torch.conj(x[..., :-1])
    inst = _angle(d) * sample_rate / real_scalar(2.0 * np.pi, x.device)
    mean_f = torch.mean(inst, dim=-1)
    std_f = _std(inst, dim=-1)
    locked = (torch.abs(mean_f - f_free_hz) > tol_hz) & (std_f < tol_hz)
    return locked, mean_f, std_f


def top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(the k largest values, their indices), descending, tied values in
    index order: ``lax.top_k`` as a stable descending sort."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def spur_scan(x, sample_rate: float, carrier_hz: float, exclude_hz: float = 1e3,
              threshold_dbc: float = -60.0, max_spurs: int = 16):
    """Spurious-emission scan (spurious_emission_scanner.rs): `(freqs[K],
    dbc[K], valid[K])` for the K = max_spurs strongest bins outside the
    carrier's exclusion (a stable descending sort: tied powers keep the
    lower bin first), `valid` False at or below threshold_dbc."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    spec = _hann_power(x)
    freqs = torch.from_numpy(np.fft.fftfreq(n, 1.0 / sample_rate).astype(np.float32)).to(x.device)
    off = torch.abs(freqs - carrier_hz)
    kc = torch.argmin(off)
    p_c = spec[kc]
    masked = torch.where(off < exclude_hz, torch.zeros((), device=x.device), spec)
    vals, idx = top_k(masked, max_spurs)
    dbc = 10.0 * torch.log10(vals / p_c + 1e-30)
    valid = dbc > threshold_dbc
    return (torch.where(valid, freqs[idx], torch.zeros((), device=x.device)),
            torch.where(valid, dbc, torch.full((), -torch.inf, device=x.device)), valid)


def spur_cancel(x, spur_hz, sample_rate: float):
    """Cancel known spurs by complex-tone least squares (spurs_mitigation.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    t = torch.arange(n, dtype=REAL_DTYPE, device=x.device) / real_scalar(sample_rate, x.device)
    if isinstance(spur_hz, torch.Tensor):
        spur_hz = spur_hz.cpu().numpy()
    y = x
    for f in np.atleast_1d(spur_hz):
        tone = cis(real_scalar(2.0 * np.pi * float(f), x.device) * t)
        amp = torch.sum(torch.conj(tone) * y, dim=-1, keepdim=True) / real_scalar(float(n),
                                                                                 x.device)
        y = y - amp * tone
    return y


# -------------------------------------------------- direction finding


def watson_watt_bearing(adcock_ns, adcock_ew, sense=None):
    """Watson–Watt DF bearing (direction_finding_watson_watt.rs): atan2 of
    the two orthogonal Adcock channel amplitudes, with optional
    sense-antenna 180° resolution."""
    ns = _real(adcock_ns)
    ew = _real(to_tensor(adcock_ew, device=ns.device))
    ref = ns / torch.clamp(torch.sqrt(torch.mean(ns ** 2)), min=1e-12)
    a_ns = torch.mean(ns * ref)
    a_ew = torch.mean(ew * ref)
    bearing = torch.rad2deg(torch.atan2(a_ew, a_ns))
    if sense is not None:
        s = torch.mean(_real(to_tensor(sense, device=ns.device)) * ref)
        bearing = torch.where(s < 0, bearing + 180.0, bearing)
    return torch.remainder(bearing, 360.0)


def df_bearing_pseudodoppler(x, sample_rate: float, rot_hz: float):
    """Pseudo-Doppler radio direction finder (radio_direction_finder.rs):
    phase of the rotation-rate component of the FM-demodulated antenna
    commutation."""
    from r4w_tpu_torch.ops import modem as _modem
    x = to_tensor(x, IQ_DTYPE)
    demod = _modem.quadrature_demod(x)
    n = demod.shape[-1]
    t = torch.arange(n, dtype=REAL_DTYPE, device=x.device) / real_scalar(sample_rate, x.device)
    ref = cis(real_scalar(-2.0 * np.pi * rot_hz, x.device) * t)
    return torch.remainder(torch.rad2deg(_angle(torch.sum(demod * ref, dim=-1))), 360.0)


def triangulate_bearings(stations_xy, bearings_deg):
    """Multi-station bearing triangulation (rdf_network_triangulator.rs):
    least-squares intersection of bearing lines, the float32 2 × 2 normal
    equations solved as the reference."""
    p = to_tensor(stations_xy, REAL_DTYPE)
    th = torch.deg2rad(to_tensor(bearings_deg, REAL_DTYPE, device=p.device))
    d = torch.stack([torch.sin(th), torch.cos(th)], dim=-1)
    proj = torch.eye(2, dtype=REAL_DTYPE, device=p.device)[None] - d[:, :, None] * d[:, None, :]
    a = torch.sum(proj, dim=0)
    b = torch.sum(proj * p[:, None, :], dim=(0, 2))
    return torch.linalg.solve(a, b)


def gps_spoof_detect(cn0_dbhz, doppler_hz, clock_drift_s_s, n_sv_strong_thresh: int = 6):
    """GNSS spoofing heuristics (gps_spoofing_detector.rs): uniform high
    C/N0 across SVs, near-identical Doppler, abnormal clock drift. Returns
    (is_spoofed, flags)."""
    cn0 = np.asarray(cn0_dbhz.cpu() if isinstance(cn0_dbhz, torch.Tensor) else cn0_dbhz, float)
    dop = np.asarray(doppler_hz.cpu() if isinstance(doppler_hz, torch.Tensor) else doppler_hz,
                     float)
    flags = {
        "uniform_cn0": bool(cn0.std() < 1.0 and (cn0 > 45.0).sum() >= n_sv_strong_thresh),
        "clustered_doppler": bool(np.std(dop) < 5.0),
        "clock_drift": bool(abs(clock_drift_s_s) > 1e-6),
    }
    return sum(flags.values()) >= 2, flags


# ------------------------------------------------------ fingerprinting


def modulation_fingerprint(x):
    """Cumulant-based modulation fingerprint vector
    (modulation_fingerprinter.rs / modulation_recognition_classifier.rs
    feature core): |C20|, |C40|, |C42|, envelope CV."""
    z = to_tensor(x, IQ_DTYPE)
    z = z / torch.sqrt(torch.mean(complex_abs(z) ** 2))
    z2 = z * z
    c20 = torch.mean(z2)
    mag = complex_abs(z)
    m2 = mag * mag
    m21 = torch.mean(m2)
    c40 = torch.mean(z2 * z2) - 3.0 * (c20 * c20)
    c42 = torch.mean(m2 * m2) - complex_abs(c20) ** 2 - 2.0 * m21 ** 2
    cv = _std(mag) / torch.clamp(torch.mean(mag), min=1e-12)
    return torch.stack([complex_abs(c20), complex_abs(c40), c42.abs(), cv])


def rf_device_fingerprint(x, n_fft: int = 1024):
    """Transmitter hardware fingerprint (rf_fingerprinting_engine.rs): CFO,
    IQ-imbalance proxy, IQ cross term, spectral tilt."""
    z = to_tensor(x, IQ_DTYPE)
    d = z[1:] * torch.conj(z[:-1])
    cfo = _angle(torch.mean(d))
    i, q = z.real, z.imag
    iq_gain = torch.sqrt(torch.mean(i * i) / torch.clamp(torch.mean(q * q), min=1e-12))
    iq_cross = torch.mean(i * q) / torch.clamp(torch.mean(complex_abs(z) ** 2), min=1e-12)
    n = min(z.shape[0], n_fft)
    spec = complex_abs(torch.fft.fft(z[:n])) ** 2
    half = n // 2
    tilt = 10.0 * torch.log10(torch.clamp(torch.mean(spec[:half]), min=1e-30)
                              / torch.clamp(torch.mean(spec[half:]), min=1e-30))
    return torch.stack([cfo, iq_gain, iq_cross, tilt])


def rf_environment_map(powers_dbm, positions_xy, grid_n: int = 32, extent: float = 100.0):
    """IDW interpolated coverage map (rf_environment_mapper.rs), one
    batched inverse-distance weighting over the grid."""
    p = to_tensor(powers_dbm, REAL_DTYPE)
    xy = to_tensor(positions_xy, REAL_DTYPE, device=p.device)
    xs = linspace(-extent, extent, grid_n, p.device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    d2 = ((xy[:, 0][:, None, None] - gx[None]) ** 2
          + (xy[:, 1][:, None, None] - gy[None]) ** 2)
    w = 1.0 / torch.clamp(d2, min=1.0)
    return torch.sum(w * p[:, None, None], dim=0) / torch.sum(w, dim=0)


def protocol_anomaly_score(msg_lengths, msg_intervals_s, train_frac: float = 0.5):
    """Protocol-behavior anomaly scoring (protocol_anomaly_detector.rs):
    z-scores of message length + inter-arrival vs the training prefix."""
    ln = to_tensor(msg_lengths, REAL_DTYPE)
    iv = to_tensor(msg_intervals_s, REAL_DTYPE, device=ln.device)
    k = max(2, int(ln.shape[0] * train_frac))
    mu_l, sd_l = torch.mean(ln[:k]), _std(ln[:k]) + 1e-9
    mu_i, sd_i = torch.mean(iv[:k]), _std(iv[:k]) + 1e-9
    return torch.sqrt(((ln - mu_l) / sd_l) ** 2 + ((iv - mu_i) / sd_i) ** 2)


# --------------------------------------------------- radio astronomy


def radiometer_total_power(x, frame: int = 1024):
    """Total-power radiometer series + radiometer-equation sensitivity
    (radio_astronomy_receiver.rs)."""
    z = to_tensor(x, IQ_DTYPE)
    p = torch.mean(complex_abs(_frames(z, frame)) ** 2, dim=-1)
    return p, 1.0 / np.sqrt(frame)


def telescope_cross_correlate(a, b, n_lags: int = 64):
    """FX correlator lag spectrum for one baseline
    (radio_telescope_correlator.rs): band-averaged complex visibility +
    fringe delay estimate + the lags."""
    x = to_tensor(a, IQ_DTYPE)
    y = to_tensor(b, IQ_DTYPE, device=x.device)
    n = x.shape[-1]
    nfft = 1 << (2 * n - 1).bit_length()
    c = torch.fft.ifft(torch.fft.fft(x, nfft) * torch.conj(torch.fft.fft(y, nfft)))
    lags = torch.cat([c[-n_lags:], c[:n_lags + 1]])
    vis = torch.mean(x * torch.conj(y))
    k = torch.argmax(complex_abs(lags)).to(torch.int32) - n_lags
    return vis, k, lags


BLOCKS = {
    "network_analyzer": ("network_analyzer_s21", "measurement",
                         "S21 magnitude+phase (network_analyzer.rs)"),
    "oscilloscope_trigger": ("oscilloscope_trigger", "measurement",
                             "edge-trigger capture "
                             "(oscilloscope_trigger.rs)",
                             ("level", "slope", "holdoff")),
    "jitter_analyzer": ("jitter_analyze", "measurement",
                        "TIE/period jitter (jitter_analyzer.rs)",
                        ("nominal_period_s",)),
    "power_meter": ("power_meter_dbm", "measurement",
                    "avg+peak dBm (power_meter.rs / "
                    "rf_power_monitor.rs)", ("impedance_ohm",)),
    "vector_signal_analyzer": ("vector_signal_analyze", "measurement",
                               "EVM/margin/PAPR/SNR report "
                               "(vector_signal_analyzer.rs)",
                               ("sps",)),
    "transmission_line_simulator": (
        "transmission_line_input_impedance", "math",
        "Zin transform (transmission_line_simulator.rs)",
        ("z0", "beta_l_rad")),
    "rf_impedance_tuner": ("stub_match", "math",
                           "single-stub match search "
                           "(rf_impedance_tuner.rs)", ("z0",)),
    "rf_circuit_em_simulator": ("microstrip_impedance", "math",
                                "Hammerstad microstrip Z0 "
                                "(rf_circuit_em_simulator.rs)",
                                ("eps_r",)),
    "antenna_design_optimizer": ("dipole_optimize", "math",
                                 "dipole resonance tuning "
                                 "(antenna_design_optimizer.rs)"),
    "rf_impairment_calibrator": ("iq_impairment_calibrate", "filter",
                                 "blind IQ imbalance cal "
                                 "(rf_impairment_calibrator.rs)"),
    "passive_intermod_analyzer": ("pim_level", "measurement",
                                  "IM-product dBc "
                                  "(passive_intermod_analyzer.rs)",
                                  ("order",)),
    "emi_conducted_analyzer": ("emi_conducted_scan", "measurement",
                               "peak/avg emission scan "
                               "(emi_conducted_analyzer.rs)",
                               ("rbw_hz",)),
    "emc_radiated_immunity": ("immunity_test_levels", "measurement",
                              "IEC 61000-4-3 profile "
                              "(emc_radiated_immunity.rs)",
                              ("field_v_per_m",)),
    "injection_locking_detector": ("injection_locking_detect",
                                   "measurement",
                                   "IF collapse detection "
                                   "(injection_locking_detector.rs)",
                                   ("f_free_hz",)),
    "spurious_emission_scanner": ("spur_scan", "measurement",
                                  "spur list in dBc "
                                  "(spurious_emission_scanner.rs)",
                                  ("carrier_hz", "threshold_dbc")),
    "spurs_mitigation": ("spur_cancel", "filter",
                         "LS tone cancellation (spurs_mitigation.rs)",
                         ("spur_hz",)),
    "direction_finding_watson_watt": ("watson_watt_bearing", "radar",
                                      "Adcock DF bearing "
                                      "(direction_finding_watson_"
                                      "watt.rs)"),
    "radio_direction_finder": ("df_bearing_pseudodoppler", "radar",
                               "pseudo-Doppler bearing "
                               "(radio_direction_finder.rs)",
                               ("rot_hz",)),
    "rdf_network_triangulator": ("triangulate_bearings", "radar",
                                 "bearing-line LS intersection "
                                 "(rdf_network_triangulator.rs)"),
    "gps_spoofing_detector": ("gps_spoof_detect", "gnss",
                              "spoofing heuristics "
                              "(gps_spoofing_detector.rs)"),
    "modulation_fingerprinter": ("modulation_fingerprint",
                                 "measurement",
                                 "cumulant fingerprint "
                                 "(modulation_fingerprinter.rs / "
                                 "modulation_recognition_"
                                 "classifier.rs)"),
    "rf_fingerprinting_engine": ("rf_device_fingerprint",
                                 "measurement",
                                 "hardware-impairment fingerprint "
                                 "(rf_fingerprinting_engine.rs)"),
    "rf_environment_mapper": ("rf_environment_map", "measurement",
                              "IDW coverage map "
                              "(rf_environment_mapper.rs)",
                              ("grid_n", "extent")),
    "protocol_anomaly_detector": ("protocol_anomaly_score",
                                  "measurement",
                                  "length/interval z-scores "
                                  "(protocol_anomaly_detector.rs)"),
    "radio_astronomy_receiver": ("radiometer_total_power",
                                 "measurement",
                                 "total-power radiometer "
                                 "(radio_astronomy_receiver.rs)",
                                 ("frame",)),
    "radio_telescope_correlator": ("telescope_cross_correlate",
                                   "measurement",
                                   "baseline visibility + fringe "
                                   "(radio_telescope_correlator.rs)",
                                   ("n_lags",)),
}
