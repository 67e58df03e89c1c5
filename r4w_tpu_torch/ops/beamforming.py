"""MIMO detection and precoding, and adaptive-array blocks.

PyTorch counterpart of ``r4w_tpu.ops.beamforming`` (mimo_detector.rs,
mimo_precoder.rs, mimo_spatial_multiplexer.rs,
orthogonal_space_time_block_code.rs, millimeter_wave_beamforming.rs,
beam_steering_controller.rs, adaptive_nulling_beamformer.rs,
generalized_sidelobe_canceller.rs, full_duplex_self_interference_canceller.rs,
noma_decoder.rs, ris_phase_controller.rs, oam_beam_generator.rs,
antenna_array_response.rs, acoustic_beamformer_adaptive.rs,
ultrasound_beam_synthesizer.rs). Detection and precoding are dense
complex64 linear algebra (``torch.linalg``; never TF32).

`mimo_detect_zf` cuts the pseudo-inverse's singular values at the
reference's ``jnp.linalg.pinv`` default, rtol = 10·max(m, n)·eps, which is
not torch's. `mimo_precode_svd`'s singular vectors are unique only up to a
phase a column, which differs between LAPACK and cuSOLVER: hold it by its
invariants (s, U·diag(s)·Vᴴ, the precoded link's decisions). `mimo_detect_ml`
is an exhaustive search whose ties take the lower index, as ``jnp.argmin``
does. `gsc_cancel` and `self_interference_cancel` are NLMS step loops, as
the reference's ``lax.scan`` is, with their state on the input's device and
no host read inside. The phase quantisers round half to even
(``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs, linspace
from r4w_tpu_torch.core.types import (IQ_DTYPE, REAL_DTYPE, real_scalar, resolve_device,
                                      to_tensor)
from r4w_tpu_torch.ops.radar import steering_vector


def _steer(n_elems: int, angle_deg: float, spacing: float = 0.5, device=None):
    """One steering vector (radar.steering_vector is batched over angles)."""
    return steering_vector(n_elems, spacing, [angle_deg], device=device)[0]


# -------------------------------------------------------- MIMO detect


def _apply(g: torch.Tensor, y) -> torch.Tensor:
    """x̂[..., t] = Σ_r g[t, r]·y[..., r]."""
    return to_tensor(y, IQ_DTYPE, device=g.device) @ g.T


def mimo_detect_zf(y, h):
    """Zero-forcing detector (mimo_detector.rs): x̂ = H⁺y. y (..., Nr),
    h (Nr, Nt). The pseudo-inverse cuts at ``jnp.linalg.pinv``'s default."""
    h = to_tensor(h, IQ_DTYPE)
    rtol = 10.0 * max(h.shape) * torch.finfo(REAL_DTYPE).eps
    return _apply(torch.linalg.pinv(h, rtol=rtol), y)


def mimo_detect_mmse(y, h, noise_var: float):
    """MMSE detector: x̂ = (HᴴH + σ²I)⁻¹Hᴴy."""
    h = to_tensor(h, IQ_DTYPE)
    hh = h.conj().T
    g = torch.linalg.solve(hh @ h + noise_var * torch.eye(h.shape[1], dtype=IQ_DTYPE,
                                                          device=h.device), hh)
    return _apply(g, y)


def mimo_detect_ml(y, h, constellation):
    """Exact ML detection over the whole Nt-fold constellation product as one
    (batch, |C|^Nt) distance computation (mimo_detector.rs). Returns (index
    combos (..., Nt), symbols (..., Nt)); ties take the lower combo."""
    h = to_tensor(h, IQ_DTYPE)
    c = to_tensor(constellation, IQ_DTYPE, device=h.device)
    nt, m = h.shape[1], c.shape[0]
    combos = torch.tensor(list(itertools.product(range(m), repeat=nt)), dtype=torch.int32,
                          device=h.device)                       # (K, Nt), the last fastest
    cand = c[combos.long()]                                      # (K, Nt)
    pred = cand @ h.T                                            # (K, Nr)
    y = to_tensor(y, IQ_DTYPE, device=h.device)
    d = torch.sum(complex_abs(y[..., None, :] - pred) ** 2, dim=-1)
    best = torch.argmin(d, dim=-1)
    return combos[best], cand[best]


def mimo_precode_svd(h):
    """SVD precoding (mimo_precoder.rs): (precoder V, combiner Uᴴ, singular
    values), so that the channel diagonalises to S."""
    u, s, vh = torch.linalg.svd(to_tensor(h, IQ_DTYPE), full_matrices=False)
    return vh.mH.resolve_conj(), u.mH.resolve_conj(), s


def spatial_multiplex(streams, device=None):
    """Map independent streams onto TX antennas (mimo_spatial_multiplexer.rs):
    an (Nt, N) stack with per-antenna power normalisation."""
    s = torch.stack([to_tensor(x, IQ_DTYPE, device=device) for x in streams])
    return s / real_scalar(float(np.sqrt(s.shape[0])), s.device)


def ostbc34_encode(syms):
    """Rate-3/4 orthogonal STBC for 4 TX antennas
    (orthogonal_space_time_block_code.rs): 3 symbols over 4 slots, the
    standard complex orthogonal design. Returns (blocks, 4 slots, 4 tx)."""
    s = to_tensor(syms, IQ_DTYPE)
    n = (s.shape[0] // 3) * 3
    s1, s2, s3 = s[0:n:3], s[1:n:3], s[2:n:3]
    z = torch.zeros_like(s1)
    c = torch.conj
    return torch.stack([
        torch.stack([s1, s2, s3, z], dim=-1),
        torch.stack([-c(s2), c(s1), z, s3], dim=-1),
        torch.stack([c(s3), z, -c(s1), s2], dim=-1),
        torch.stack([z, c(s3), -c(s2), -s1], dim=-1),
    ], dim=1)


def ostbc34_decode(rx_blocks, h):
    """Matched-filter combining for the rate-3/4 OSTBC over a flat channel
    h (4,) to one receive antenna."""
    r = to_tensor(rx_blocks, IQ_DTYPE)          # (B, 4)
    h = to_tensor(h, IQ_DTYPE, device=r.device)
    c = torch.conj
    h1, h2, h3, h4 = h[0], h[1], h[2], h[3]
    r1, r2, r3, r4 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    s1 = c(h1) * r1 + h2 * c(r2) - h3 * c(r3) - c(h4) * r4
    s2 = c(h2) * r1 - h1 * c(r2) + c(h4) * r3 - h3 * c(r4)
    s3 = c(h3) * r1 + c(h4) * r2 + h1 * c(r3) + h2 * c(r4)
    norm = torch.sum(complex_abs(h) ** 2)
    return (torch.stack([s1, s2, s3], dim=-1) / norm).reshape(-1)


# ----------------------------------------------------- power-domain SIC


def noma_superpose(x_near, x_far, p_near: float = 0.2):
    """Power-domain NOMA superposition (noma_decoder.rs TX side)."""
    a = to_tensor(x_near, IQ_DTYPE)
    b = to_tensor(x_far, IQ_DTYPE, device=a.device)
    return float(np.sqrt(p_near)) * a + float(np.sqrt(1.0 - p_near)) * b


def noma_decode_near(y, constellation, p_near: float = 0.2):
    """Near-user SIC decode (noma_decoder.rs / successive_interference_canceller.rs):
    decode the strong (far) user, subtract it, decode the own signal.
    Returns (near indices, far indices) int32."""
    y = to_tensor(y, IQ_DTYPE)
    c = to_tensor(constellation, IQ_DTYPE, device=y.device)
    far_scale = float(np.sqrt(1.0 - p_near))
    far_idx = torch.argmin(complex_abs(y[:, None] - far_scale * c[None, :]), dim=-1)
    resid = y - far_scale * c[far_idx]
    near_idx = torch.argmin(complex_abs(resid[:, None] - float(np.sqrt(p_near)) * c[None, :]),
                            dim=-1)
    return near_idx.to(torch.int32), far_idx.to(torch.int32)


# ------------------------------------------------------ adaptive arrays


def array_response(n_elems: int, angles_deg, spacing: float = 0.5, device=None):
    """Array manifold over a set of angles (antenna_array_response.rs): the
    (n_angles, n_elems) steering matrix."""
    a = torch.atleast_1d(to_tensor(angles_deg, REAL_DTYPE, device=device))
    return steering_vector(n_elems, spacing, a)


def lcmv_weights(r, constraints, gains):
    """Linearly-constrained minimum-variance beamformer
    (adaptive_nulling_beamformer.rs / rf_mitigation_adaptive_nulling.rs):
    w = R⁻¹C (CᴴR⁻¹C)⁻¹ g. constraints (N, K), gains (K,)."""
    r = to_tensor(r, IQ_DTYPE)
    c = to_tensor(constraints, IQ_DTYPE, device=r.device)
    g = to_tensor(gains, IQ_DTYPE, device=r.device)
    rinv_c = torch.linalg.solve(r, c)
    return rinv_c @ torch.linalg.solve(c.conj().T @ rinv_c, g)


def null_steer_weights(n_elems: int, look_deg: float, null_degs, spacing: float = 0.5,
                       loading: float = 1e-3, device=None):
    """Unity gain at look_deg and hard nulls at null_degs by LCMV with an
    identity-plus-interference covariance."""
    device = resolve_device(device)
    look = _steer(n_elems, look_deg, spacing, device)
    nulls = [_steer(n_elems, d, spacing, device) for d in null_degs]
    c = torch.stack([look] + nulls, dim=-1)
    g = torch.tensor([1.0] + [0.0] * len(nulls), dtype=IQ_DTYPE, device=device)
    r = torch.eye(n_elems, dtype=IQ_DTYPE, device=device) * loading
    for v in nulls:
        r = r + torch.outer(v, torch.conj(v))
    return lcmv_weights(r, c, g)


def _nlms(u: torch.Tensor, d: torch.Tensor, mu: float):
    """NLMS over the rows of u (T, L) against d (T,): w ← w + μ·e*·u/(uᴴu +
    1e-6) with e = d − wᴴu. Returns (errors (T,), final w). A step loop."""
    w = torch.zeros(u.shape[1], dtype=IQ_DTYPE, device=u.device)
    err = torch.empty_like(d)
    norms = torch.sum(u.real ** 2 + u.imag ** 2, dim=1) + 1e-6
    for t in range(d.shape[0]):
        e = d[t] - torch.sum(torch.conj(w) * u[t])
        w = w + mu * torch.conj(e) * u[t] / norms[t]
        err[t] = e
    return err, w


def gsc_cancel(x, look_deg: float, spacing: float = 0.5, mu: float = 0.05,
               n_iter: int | None = None):
    """Generalized sidelobe canceller (generalized_sidelobe_canceller.rs):
    fixed beamformer + blocking matrix + NLMS adaptive branch. x (N, T)."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[0]
    # steering vector and blocking matrix are design-time numpy, as in the
    # reference: the orthogonal complement of the look direction
    v = np.exp(1j * 2.0 * np.pi * spacing * np.sin(np.deg2rad(look_deg)) * np.arange(n)) / n
    d_vec = torch.from_numpy(v.astype(np.complex64)).to(x.device)
    main = torch.conj(d_vec) @ x
    q, _ = np.linalg.qr(np.column_stack([v, np.eye(n)[:, : n - 1]]))
    b = torch.from_numpy(q[:, 1:].astype(np.complex64)).to(x.device)   # (N, N-1)
    blocked = torch.conj(b).T @ x                                       # (N-1, T)
    out, _ = _nlms(blocked.T.contiguous(), main, mu)
    return out


def self_interference_cancel(rx, tx_known, n_taps: int = 32, mu: float = 0.5):
    """Full-duplex digital SI canceller (full_duplex_self_interference_canceller.rs /
    adaptive_interference_canceller.rs): NLMS from the known transmit stream
    onto the receive stream. Returns (error, final taps)."""
    d = to_tensor(rx, IQ_DTYPE)
    x = to_tensor(tx_known, IQ_DTYPE, device=d.device)
    xpad = torch.cat([torch.zeros(n_taps - 1, dtype=IQ_DTYPE, device=d.device), x])
    idx = (torch.arange(d.shape[0], device=d.device)[:, None]
           + torch.arange(n_taps, device=d.device)[None, :])
    return _nlms(xpad[idx].flip(-1), d, mu)


# --------------------------------------------------- mmWave / RIS / OAM


def mmwave_beam_search(h, codebook_bits: int = 4, n_elems: int = 16, spacing: float = 0.5):
    """Analog beam training (millimeter_wave_beamforming.rs): sweep a DFT
    codebook in one product. Returns (best index, gains, its angle)."""
    h = to_tensor(h, IQ_DTYPE)
    angles = linspace(-90.0, 90.0, 1 << codebook_bits, h.device)
    book = array_response(n_elems, angles, spacing)              # (B, N)
    gains = complex_abs(book.conj() @ h) / real_scalar(float(np.sqrt(n_elems)), h.device)
    k = torch.argmax(gains)
    return k, gains, angles[k]


def _quantise(ph: torch.Tensor, bits: int) -> torch.Tensor:
    step = 2.0 * np.pi / (1 << bits)
    return torch.round(ph / real_scalar(step, ph.device)) * step


def beam_steering_phases(n_elems: int, angle_deg: float, spacing: float = 0.5,
                         quant_bits: int = 0, device=None):
    """Per-element phase commands (beam_steering_controller.rs); optional
    phase-shifter quantisation."""
    ph = torch.angle(_steer(n_elems, angle_deg, spacing, resolve_device(device)))
    return _quantise(ph, quant_bits) if quant_bits > 0 else ph


def ris_phase_config(h_tx_ris, h_ris_rx, quant_bits: int = 2):
    """RIS phase configuration (ris_phase_controller.rs): co-phase the
    cascaded channel h2[n]·e^{jφn}·h1[n] with quantised phase shifters.
    Returns (phases, gain)."""
    h1 = to_tensor(h_tx_ris, IQ_DTYPE)
    h2 = to_tensor(h_ris_rx, IQ_DTYPE, device=h1.device)
    phases = _quantise(-torch.angle(h1 * h2), quant_bits)
    return phases, complex_abs(torch.sum(h1 * h2 * cis(phases)))


def oam_beam(n_elems_ring: int, mode: int, device=None):
    """Uniform-circular-array OAM excitation (oam_beam_generator.rs):
    element k gets phase 2π·mode·k/N; modes are orthogonal."""
    device = resolve_device(device)
    k = torch.arange(n_elems_ring, dtype=REAL_DTYPE, device=device)
    return (cis(2.0 * np.pi * mode * k / real_scalar(n_elems_ring, device))
            / real_scalar(float(np.sqrt(n_elems_ring)), device))


def delay_and_sum(x, delays):
    """Time-domain delay-and-sum beamformer (acoustic_beamformer_adaptive.rs
    fixed part / ultrasound_beam_synthesizer.rs): integer-sample circular
    delays, x (N, T)."""
    x = to_tensor(x)
    d = to_tensor(delays, torch.int64, device=x.device)
    t = x.shape[-1]
    idx = torch.remainder(torch.arange(t, device=x.device)[None, :] + d[:, None], t)
    return torch.mean(torch.gather(x, -1, idx), dim=0)


def ultrasound_focus_delays(n_elems: int, pitch_m: float, focus_m: float, c: float = 1540.0,
                            fs: float = 20e6, device=None):
    """Focusing delay profile of an ultrasound array
    (ultrasound_beam_synthesizer.rs): geometric path-length differences to a
    focal point on the axis, in samples."""
    xk = (np.arange(n_elems) - (n_elems - 1) / 2.0) * pitch_m
    dt = (np.sqrt(focus_m ** 2 + xk ** 2) - focus_m) / c
    return torch.from_numpy(np.round(dt * fs).astype(np.int32)).to(resolve_device(device))


BLOCKS = {
    "mimo_detector": ("mimo_detect_mmse", "demodulator",
                      "ZF/MMSE/ML MIMO detection (mimo_detector.rs)",
                      ("noise_var",)),
    "mimo_precoder": ("mimo_precode_svd", "modulator",
                      "SVD precoding (mimo_precoder.rs)"),
    "mimo_spatial_multiplexer": ("spatial_multiplex", "modulator",
                                 "stream->antenna mapping "
                                 "(mimo_spatial_multiplexer.rs)"),
    "orthogonal_stbc": ("ostbc34_encode", "modulator",
                        "rate-3/4 4-TX OSTBC "
                        "(orthogonal_space_time_block_code.rs)"),
    "noma_decoder": ("noma_decode_near", "demodulator",
                     "power-domain NOMA SIC (noma_decoder.rs)",
                     ("p_near",)),
    "antenna_array_response": ("array_response", "math",
                               "array manifold "
                               "(antenna_array_response.rs)",
                               ("n_elems", "spacing")),
    "adaptive_nulling_beamformer": ("null_steer_weights", "radar",
                                    "LCMV null steering "
                                    "(adaptive_nulling_beamformer.rs)",
                                    ("look_deg", "null_degs")),
    "generalized_sidelobe_canceller": (
        "gsc_cancel", "radar",
        "GSC fixed+adaptive branch "
        "(generalized_sidelobe_canceller.rs)", ("look_deg",)),
    "full_duplex_si_canceller": (
        "self_interference_cancel", "filter",
        "NLMS self-interference canceller "
        "(full_duplex_self_interference_canceller.rs)", ("n_taps",)),
    "mmwave_beam_search": ("mmwave_beam_search", "radar",
                           "DFT codebook beam training "
                           "(millimeter_wave_beamforming.rs)",
                           ("codebook_bits",)),
    "beam_steering_controller": ("beam_steering_phases", "radar",
                                 "phase commands + quantization "
                                 "(beam_steering_controller.rs)",
                                 ("angle_deg", "quant_bits")),
    "ris_phase_controller": ("ris_phase_config", "radar",
                             "RIS co-phasing (ris_phase_controller.rs)",
                             ("quant_bits",)),
    "oam_beam_generator": ("oam_beam", "source",
                           "UCA OAM mode excitation "
                           "(oam_beam_generator.rs)", ("mode",)),
    "delay_and_sum_beamformer": ("delay_and_sum", "radar",
                                 "time-domain delay&sum "
                                 "(acoustic_beamformer_adaptive.rs)"),
    "ultrasound_beam_synthesizer": ("ultrasound_focus_delays", "radar",
                                    "focal delay profile "
                                    "(ultrasound_beam_synthesizer.rs)",
                                    ("pitch_m", "focus_m")),
}
