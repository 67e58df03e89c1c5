"""Specialty modems and power-systems analysis.

PyTorch counterpart of ``r4w_tpu.ops.exotic_modems`` (jt65_modulator.rs,
wspr_modulator.rs, underwater_acoustic_modem.rs,
powerline_carrier_modem.rs, rfid_backscatter_receiver.rs,
ambient_backscatter_processor.rs, vlc_modulator.rs,
optical_coherent_receiver.rs, dab_plus.rs, drm_ofdm_processor.rs,
industrial_process_modulation.rs, ev_motor_commutation_controller.rs,
photovoltaic_mppt_controller.rs, phasor_measurement_unit.rs,
power_line_harmonic_analyzer.rs, power_quality_harmonics_analyzer.rs,
power_quality_event_classifier.rs, quantum_key_distribution.rs,
photonic_processing.rs, wavelength_division_mux.rs).

Each modem is a TX/RX pair over batched tone synthesis and a Goertzel
bank, a (symbols × tones) FP32 product (no TF32); power-systems analysis
is one windowed DFT. Tone phases are float32, as the reference's are:
the symbol-boundary phases are a cumulative sum accumulated in float64
and rounded (`filters._cumsum`), so the card's phases equal the CPU's;
the reference's float32 scan rounds each partial sum, so long
transmissions (WSPR reaches 10^5 rad, where float32's spacing is 0.016
rad) differ from it by a few of those spacings. The WDM demultiplexer
filters all its channels as rows of one FIR launch. The powerline
receiver reads its symbol energies to the host for its medians, as the
reference does (once a call). Host-only helpers (DRM numerology, MPPT,
BLDC, BB84's draws, the power-quality frame loop) are copies.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, resolve_device, to_tensor
from r4w_tpu_torch.ops.filters import _cumsum

# ----------------------------------------------------------- WSJT-ish

_JT65_NTONES = 65
_JT65_TONE_SPACING = 2.6917  # Hz
_JT65_SYM_S = 0.372

_WSPR_NTONES = 4
_WSPR_TONE_SPACING = 1.4648
_WSPR_SYM_S = 0.6827


def _times(length: int, sample_rate: float, device) -> torch.Tensor:
    """(length,) float32 n/fs, the quotient rounded as the reference rounds it."""
    return (torch.arange(length, dtype=REAL_DTYPE, device=device)
            / real_scalar(sample_rate, device))


def _fsk_phase(freqs: torch.Tensor, sym_len: int, sample_rate: float) -> torch.Tensor:
    """(n_sym, sym_len) phase-continuous tone phases: each symbol starts at
    the phase the previous ones accumulated."""
    dev = freqs.device
    dphi = 2.0 * np.pi * freqs * sym_len / real_scalar(sample_rate, dev)
    phi0 = torch.cat([dphi.new_zeros((1,)), _cumsum(dphi)[:-1]])
    t = _times(sym_len, sample_rate, dev)
    return phi0[:, None] + 2.0 * np.pi * freqs[:, None] * t[None, :]


def _mfsk_modulate(symbols, n_tones: int, tone_spacing: float,
                   sym_s: float, sample_rate: float,
                   base_hz: float = 1270.5) -> torch.Tensor:
    """Shared MFSK synth for the WSJT family: one row per symbol via a
    (n_sym, sym_len) phase grid; phase-continuous across symbols."""
    s = to_tensor(symbols, torch.int32)
    sym_len = int(round(sym_s * sample_rate))
    freqs = base_hz + s.to(REAL_DTYPE) * tone_spacing
    del n_tones
    return cis(_fsk_phase(freqs, sym_len, sample_rate)).reshape(-1)


def _frames(x: torch.Tensor, sym_len: int) -> torch.Tensor:
    n_sym = x.shape[0] // sym_len
    return x[: n_sym * sym_len].reshape(n_sym, sym_len)


def _energy(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """|frames @ basis|² with the reference's compiled |·|."""
    return complex_abs(frames @ basis) ** 2


def _mfsk_demodulate(x, n_tones: int, tone_spacing: float, sym_s: float,
                     sample_rate: float, base_hz: float = 1270.5) -> torch.Tensor:
    x = to_tensor(x, IQ_DTYPE)
    sym_len = int(round(sym_s * sample_rate))
    dev = x.device
    t = _times(sym_len, sample_rate, dev)
    freqs = base_hz + torch.arange(n_tones, dtype=REAL_DTYPE, device=dev) * tone_spacing
    basis = cis(-2.0 * np.pi * freqs[:, None] * t[None, :])
    return torch.argmax(_energy(_frames(x, sym_len), basis.T), dim=-1).to(torch.int32)


def jt65_modulate(symbols, sample_rate: float = 11025.0) -> torch.Tensor:
    """JT65 65-FSK symbol synthesis (jt65_modulator.rs): 2.69 Hz tone
    grid, 0.372 s symbols, phase-continuous."""
    return _mfsk_modulate(symbols, _JT65_NTONES, _JT65_TONE_SPACING,
                          _JT65_SYM_S, sample_rate)


def jt65_demodulate(x, sample_rate: float = 11025.0) -> torch.Tensor:
    return _mfsk_demodulate(x, _JT65_NTONES, _JT65_TONE_SPACING,
                            _JT65_SYM_S, sample_rate)


def wspr_modulate(symbols, sample_rate: float = 12000.0) -> torch.Tensor:
    """WSPR 4-FSK synthesis (wspr_modulator.rs): 1.4648 Hz spacing,
    0.683 s symbols."""
    return _mfsk_modulate(symbols, _WSPR_NTONES, _WSPR_TONE_SPACING,
                          _WSPR_SYM_S, sample_rate)


def wspr_demodulate(x, sample_rate: float = 12000.0) -> torch.Tensor:
    return _mfsk_demodulate(x, _WSPR_NTONES, _WSPR_TONE_SPACING,
                            _WSPR_SYM_S, sample_rate)


# ------------------------------------------------------- underwater


def underwater_modulate(bits, sample_rate: float = 48000.0,
                        f0: float = 9000.0, f1: float = 11000.0,
                        baud: float = 100.0) -> torch.Tensor:
    """Underwater acoustic FSK modem TX (underwater_acoustic_modem.rs):
    slow FSK with raised-cosine symbol shaping against the
    reverberant channel."""
    b = to_tensor(bits, torch.int32)
    sym_len = int(sample_rate / baud)
    freqs = torch.where(b > 0, f1, f0).to(REAL_DTYPE)
    ramp = torch.from_numpy((np.hanning(sym_len) ** 0.25).astype(np.float32)).to(b.device)
    return (cis(_fsk_phase(freqs, sym_len, sample_rate)) * ramp[None, :]).reshape(-1)


def _carrier(f: float, t: torch.Tensor) -> torch.Tensor:
    return cis(-2.0 * np.pi * f * t)


def underwater_demodulate(x, sample_rate: float = 48000.0,
                          f0: float = 9000.0, f1: float = 11000.0,
                          baud: float = 100.0) -> torch.Tensor:
    """Noncoherent dual-tone energy detection (robust to multipath
    phase)."""
    x = to_tensor(x, IQ_DTYPE)
    sym_len = int(sample_rate / baud)
    frames = _frames(x, sym_len)
    t = _times(sym_len, sample_rate, x.device)
    e0 = _energy(frames, _carrier(f0, t))
    e1 = _energy(frames, _carrier(f1, t))
    return (e1 > e0).to(torch.int32)


# --------------------------------------------------------- powerline


def plc_modulate(bits, sample_rate: float = 250e3,
                 carriers_hz=(75e3, 85e3), baud: float = 2400.0) -> torch.Tensor:
    """Powerline-carrier S-FSK modem (powerline_carrier_modem.rs):
    spread-frequency-shift keying on two widely spaced carriers so
    narrowband powerline noise only hits one."""
    return underwater_modulate(bits, sample_rate, carriers_hz[0],
                               carriers_hz[1], baud)


def plc_demodulate(x, sample_rate: float = 250e3,
                   carriers_hz=(75e3, 85e3), baud: float = 2400.0) -> torch.Tensor:
    """S-FSK receive decision (IEC 61334-5-1 style, the point of
    powerline_carrier_modem.rs): per-carrier quality = bimodality of
    the symbol-energy distribution. A jammed carrier is 'always on'
    (low bimodality) — demodulate from the clean carrier alone against
    its own threshold instead of comparing the two energies. The energies
    are read to the host once for the medians."""
    x = to_tensor(x, IQ_DTYPE)
    sym_len = int(sample_rate / baud)
    frames = _frames(x, sym_len)
    t = _times(sym_len, sample_rate, x.device)
    e0 = _energy(frames, _carrier(carriers_hz[0], t)).cpu().numpy()
    e1 = _energy(frames, _carrier(carriers_hz[1], t)).cpu().numpy()

    def quality(e):
        s = np.sort(e)
        lo = np.median(s[: max(1, len(s) // 2)])
        hi = np.median(s[len(s) // 2:])
        return hi / max(lo, 1e-12)

    q0, q1 = quality(e0), quality(e1)
    if min(q0, q1) > 3.0:            # both carriers clean
        bits = e1 > e0
    elif q1 >= q0:                    # carrier 0 jammed -> use f1 only
        thr = 0.5 * (np.median(np.sort(e1)[: len(e1) // 2])
                     + np.median(np.sort(e1)[len(e1) // 2:]))
        bits = e1 > thr
    else:                             # carrier 1 jammed -> use f0 only
        thr = 0.5 * (np.median(np.sort(e0)[: len(e0) // 2])
                     + np.median(np.sort(e0)[len(e0) // 2:]))
        bits = ~(e0 > thr)
    return torch.from_numpy(bits.astype(np.int32)).to(x.device)


# -------------------------------------------------------- backscatter


def rfid_backscatter_decode(x, blf_hz: float, sample_rate: float) -> torch.Tensor:
    """FM0-coded RFID backscatter decode
    (rfid_backscatter_receiver.rs): envelope → matched half-bit
    integrate → FM0 transitions. Returns bits."""
    env = complex_abs(to_tensor(x, IQ_DTYPE))
    env = env - torch.mean(env)
    half = max(1, int(round(sample_rate / blf_hz / 2.0)))
    n_half = env.shape[0] // half
    signs = torch.sign(torch.sum(env[: n_half * half].reshape(n_half, half), dim=-1))
    # FM0: transition at every bit boundary; mid-bit transition = 0
    return (signs[0:n_half - 1:2] == signs[1:n_half:2]).to(torch.int32)


def ambient_backscatter_detect(x, frame: int = 64):
    """Ambient-backscatter bit detection
    (ambient_backscatter_processor.rs): averaged envelope levels
    cluster into reflect/absorb states; threshold at the midpoint."""
    x = to_tensor(x)
    env = complex_abs(x.to(IQ_DTYPE)) if x.is_complex() else torch.abs(x.to(REAL_DTYPE))
    n = (env.shape[0] // frame) * frame
    levels = torch.mean(env[:n].reshape(-1, frame), dim=-1)
    thr = 0.5 * (torch.amax(levels) + torch.amin(levels))
    return (levels > thr).to(torch.int32), levels


# --------------------------------------------------------------- VLC


def vlc_modulate(bits, sps: int = 8, kind: str = "ook_manchester",
                 dimming: float = 0.5) -> torch.Tensor:
    """Visible-light OOK/VPPM modulation (vlc_modulator.rs):
    Manchester-coded intensity (non-negative) with dimming support."""
    b = to_tensor(bits, torch.int32)
    dev = b.device
    half = sps // 2
    if kind == "ook_manchester":
        hi = torch.ones((half,), dtype=REAL_DTYPE, device=dev)
        lo = torch.zeros((half,), dtype=REAL_DTYPE, device=dev)
        one, zero = torch.cat([hi, lo]), torch.cat([lo, hi])
        wave = torch.where(b[:, None] > 0, one[None, :], zero[None, :])
        return (wave * 2.0 * dimming).reshape(-1)
    if kind == "vppm":
        width = float(np.clip(np.float32(dimming), np.float32(0.1), np.float32(0.9)))
        pos = torch.where(b > 0, 0.0, 1.0 - width).to(REAL_DTYPE)
        t = torch.arange(sps, dtype=REAL_DTYPE, device=dev) / real_scalar(sps, dev)
        wave = ((t[None, :] >= pos[:, None])
                & (t[None, :] < pos[:, None] + width)).to(REAL_DTYPE)
        return wave.reshape(-1)
    raise ValueError(f"unknown VLC kind '{kind}'")


def vlc_demodulate(intensity, sps: int = 8) -> torch.Tensor:
    """Manchester OOK decode: first-half minus second-half energy."""
    frames = _frames(to_tensor(intensity, REAL_DTYPE), sps)
    half = sps // 2
    return (torch.sum(frames[:, :half], dim=-1)
            > torch.sum(frames[:, half:], dim=-1)).to(torch.int32)


# ------------------------------------------------------------ optical


def coherent_optical_receive(x, constellation, loop_bw: float = 0.02):
    """Coherent optical DSP chain (optical_coherent_receiver.rs):
    CD-free toy chain = power normalize → Viterbi&Viterbi phase
    recovery → decisions."""
    from r4w_tpu_torch.ops import mapping as _mapping
    from r4w_tpu_torch.ops import sync2 as _sync2
    x = to_tensor(x, IQ_DTYPE)
    x = x / torch.sqrt(torch.mean(complex_abs(x) ** 2))
    y, _ = _sync2.carrier_recovery_mpsk(x, order=4, bw=loop_bw)
    return _mapping.symbol_demap(y, constellation), y


def _comb(k: int, count: int, spacing_cycles: float, t: torch.Tensor, sign: float) -> torch.Tensor:
    return cis(sign * 2.0 * np.pi * (k - (count - 1) / 2.0) * spacing_cycles * t)


def wdm_mux(channels, spacing_cycles: float = 0.2) -> torch.Tensor:
    """Wavelength-division multiplex N baseband channels onto an
    optical-frequency comb (wavelength_division_mux.rs): channel k at
    offset k·spacing (cycles/sample), summed in channel order."""
    chans = [to_tensor(c, IQ_DTYPE) for c in channels]
    n = chans[0].shape[0]
    t = torch.arange(n, dtype=REAL_DTYPE, device=chans[0].device)
    out = chans[0].new_zeros((n,))
    for k, c in enumerate(chans):
        out = out + c * _comb(k, len(chans), spacing_cycles, t, 1.0)
    return out


def wdm_demux(x, n_channels: int, spacing_cycles: float = 0.2,
              n_taps: int = 101) -> torch.Tensor:
    """Inverse: mix each channel to baseband + lowpass; the channels are
    the rows of one FIR call."""
    from r4w_tpu_torch.ops import filters as _filters
    x = to_tensor(x, IQ_DTYPE)
    t = torch.arange(x.shape[0], dtype=REAL_DTYPE, device=x.device)
    lp = _filters.design_lowpass(n_taps, spacing_cycles / 2.5, 1.0)
    mixed = torch.stack([x * _comb(k, n_channels, spacing_cycles, t, -1.0)
                         for k in range(n_channels)])
    return _filters.fir_apply(lp, mixed)


def photonic_mzi_transfer(phase_rad, extinction_db: float = 30.0) -> torch.Tensor:
    """Mach-Zehnder interferometer intensity transfer
    (photonic_processing.rs): T = cos²(φ/2) with finite extinction."""
    p = to_tensor(phase_rad, REAL_DTYPE)
    leak = 10.0 ** (-extinction_db / 10.0)
    return (1.0 - leak) * torch.cos(p / 2.0) ** 2 + leak


# ------------------------------------------------------------ DAB/DRM


def _dab_carriers(n_carriers: int, n_fft: int, device) -> torch.Tensor:
    half = n_carriers // 2
    return torch.cat([torch.arange(-half, 0, device=device),
                      torch.arange(1, half + 1, device=device)]) % n_fft


def dab_symbol_modulate(bits, n_carriers: int = 1536, n_fft: int = 2048):
    """DAB-style DQPSK-OFDM symbol chain (dab_plus.rs): π/4-DQPSK per
    carrier across symbols, centered carrier allocation, CP."""
    b = to_tensor(bits, torch.int32)
    dev = b.device
    n = (b.shape[0] // (2 * n_carriers)) * (2 * n_carriers)
    pairs = b[:n].reshape(-1, n_carriers, 2)
    phases = (np.pi / 2.0) * (2 * pairs[..., 0] + pairs[..., 1]).to(REAL_DTYPE) + np.pi / 4.0
    # differential across OFDM symbols (first symbol = reference ones)
    ref = torch.zeros((1, n_carriers), dtype=REAL_DTYPE, device=dev)
    cum = _cumsum(torch.cat([ref, phases], dim=0).T).T.contiguous()
    grid = torch.zeros((cum.shape[0], n_fft), dtype=IQ_DTYPE, device=dev)
    grid[:, _dab_carriers(n_carriers, n_fft, dev)] = cis(cum)
    td = torch.fft.ifft(grid, dim=-1)
    cp = n_fft // 4
    return torch.cat([td[:, n_fft - cp:], td], dim=-1).reshape(-1), cum


def dab_symbol_demodulate(x, n_carriers: int = 1536, n_fft: int = 2048) -> torch.Tensor:
    """Differential demod across symbols — no channel estimate needed
    (the DAB design point)."""
    x = to_tensor(x, IQ_DTYPE)
    cp = n_fft // 4
    sym_len = n_fft + cp
    n_sym = x.shape[0] // sym_len
    frames = x[: n_sym * sym_len].reshape(n_sym, sym_len)[:, cp:]
    carriers = torch.fft.fft(frames, dim=-1)[:, _dab_carriers(n_carriers, n_fft, x.device)]
    diff = carriers[1:] * torch.conj(carriers[:-1])
    ph = (torch.angle(diff) - np.pi / 4.0) / (np.pi / 2.0)
    q = torch.round(ph).to(torch.int32) % 4
    return torch.stack([q // 2, q % 2], dim=-1).reshape(-1)


def drm_ofdm_params(mode: str = "B"):
    """DRM OFDM numerology table (drm_ofdm_processor.rs)."""
    table = {
        "A": {"t_u_ms": 24.0, "t_g_ms": 2.66, "carriers": 226},
        "B": {"t_u_ms": 21.33, "t_g_ms": 5.33, "carriers": 206},
        "C": {"t_u_ms": 14.66, "t_g_ms": 5.33, "carriers": 138},
        "D": {"t_u_ms": 9.33, "t_g_ms": 7.33, "carriers": 88},
    }
    return table[mode]


# ----------------------------------------------------- power systems


def pmu_phasor(x, sample_rate: float, f_nominal: float = 50.0):
    """Synchrophasor estimate (phasor_measurement_unit.rs): amplitude,
    phase and frequency of the fundamental over one reporting window,
    via the DFT at nominal + frequency correction from phase slope."""
    x = to_tensor(x, REAL_DTYPE)
    n = x.shape[0]
    basis = _carrier(f_nominal, _times(n, sample_rate, x.device))
    half = n // 2
    p1 = torch.sum(x[:half] * basis[:half]) * (2.0 / half)
    p2 = torch.sum(x[half:] * basis[half:]) * (2.0 / (n - half))
    dphi = torch.angle(p2 * torch.conj(p1))
    f_est = f_nominal + dphi / real_scalar(2.0 * np.pi * (half / sample_rate), x.device)
    phasor = (p1 + p2) / 2.0
    return complex_abs(phasor), torch.angle(phasor), f_est


def harmonics_analyze(x, sample_rate: float, f0: float = 50.0,
                      n_harmonics: int = 13):
    """Harmonic amplitudes + THD (power_line_harmonic_analyzer.rs /
    power_quality_harmonics_analyzer.rs) via a Goertzel bank at k·f0."""
    x = to_tensor(x, REAL_DTYPE)
    n = x.shape[0]
    dev = x.device
    t = _times(n, sample_rate, dev)
    k = torch.arange(1, n_harmonics + 1, dtype=REAL_DTYPE, device=dev)
    basis = cis(-2.0 * np.pi * f0 * k[:, None] * t[None, :])
    amps = complex_abs(basis @ x.to(IQ_DTYPE)) * (2.0 / n)
    thd = torch.sqrt(torch.sum(amps[1:] ** 2)) / torch.clamp(amps[0], min=1e-12)
    return amps, thd


def power_quality_classify(x, sample_rate: float, f0: float = 50.0,
                           frame_cycles: int = 1, device=None):
    """Sag/swell/interruption/harmonic event classification per frame
    (power_quality_event_classifier.rs): RMS vs nominal + THD, each
    frame's harmonics on `device` (default the card)."""
    x = np.asarray(x, np.float64)
    frame = int(sample_rate / f0) * frame_cycles
    n_frames = x.shape[0] // frame
    nominal = None
    events = []
    for i in range(n_frames):
        seg = x[i * frame:(i + 1) * frame]
        rms = np.sqrt(np.mean(seg ** 2))
        if nominal is None:
            nominal = rms
        r = rms / nominal
        _, thd = harmonics_analyze(to_tensor(seg, REAL_DTYPE, device), sample_rate, f0, 7)
        if r < 0.1:
            events.append((i, "interruption"))
        elif r < 0.9:
            events.append((i, "sag"))
        elif r > 1.1:
            events.append((i, "swell"))
        elif float(thd) > 0.1:
            events.append((i, "harmonic"))
    return events


def mppt_perturb_observe(v, i, v_step: float = 0.1,
                         state: tuple = (0.0, 0.0, 1.0)):
    """Perturb-and-observe MPPT command
    (photovoltaic_mppt_controller.rs): returns (new_v_ref, state)."""
    p = v * i
    p_prev, v_prev, direction = state
    if p < p_prev:
        direction = -direction
    v_ref = v + direction * v_step
    return v_ref, (p, v, direction)


def bldc_commutation(theta_rad, pole_pairs: int = 4):
    """Six-step BLDC commutation state from the electrical angle
    (ev_motor_commutation_controller.rs): returns the sector 0-5 and
    the three phase drive levels."""
    elec = (np.asarray(theta_rad) * pole_pairs) % (2.0 * np.pi)
    sector = (elec / (np.pi / 3.0)).astype(int) % 6
    table = np.array([
        [1, -1, 0], [1, 0, -1], [0, 1, -1],
        [-1, 1, 0], [-1, 0, 1], [0, -1, 1]])
    return sector, table[sector]


def industrial_4_20ma_encode(values, lo: float, hi: float) -> torch.Tensor:
    """4–20 mA process-current encoding
    (industrial_process_modulation.rs)."""
    v = to_tensor(values, REAL_DTYPE)
    frac = torch.clamp((v - lo) / real_scalar(hi - lo, v.device), 0.0, 1.0)
    return 4.0 + 16.0 * frac


def industrial_4_20ma_decode(ma, lo: float, hi: float) -> torch.Tensor:
    cur = torch.clamp(to_tensor(ma, REAL_DTYPE), 4.0, 20.0)
    return lo + (cur - 4.0) / real_scalar(16.0, cur.device) * (hi - lo)


# --------------------------------------------------------------- QKD


def bb84_sift(key, n_bits: int, error_rate: float = 0.0, seed: int = 0, device=None):
    """BB84 protocol simulation (quantum_key_distribution.rs): random
    bases for Alice/Bob, sifting, QBER estimate, the reference's numpy
    draws. Returns (sifted_key_alice, sifted_key_bob, qber), the keys on
    `device` (default the card)."""
    rng = np.random.default_rng(seed)
    alice_bits = rng.integers(0, 2, n_bits)
    alice_bases = rng.integers(0, 2, n_bits)
    bob_bases = rng.integers(0, 2, n_bits)
    # measurement: same basis -> alice's bit (maybe flipped by noise),
    # different basis -> random
    noise = rng.uniform(size=n_bits) < error_rate
    rand_bits = rng.integers(0, 2, n_bits)
    bob_bits = np.where(alice_bases == bob_bases,
                        alice_bits ^ noise.astype(np.int64), rand_bits)
    keep = alice_bases == bob_bases
    a, b = alice_bits[keep], bob_bits[keep]
    qber = float(np.mean(a != b)) if a.shape[0] else 0.0
    del key
    dev = resolve_device(device)
    return (torch.from_numpy(a.astype(np.int32)).to(dev),
            torch.from_numpy(b.astype(np.int32)).to(dev), qber)


BLOCKS = {
    "jt65_modulator": ("jt65_modulate", "modulator",
                       "65-FSK JT65 synth (jt65_modulator.rs)",
                       ("sample_rate",)),
    "wspr_modulator": ("wspr_modulate", "modulator",
                       "WSPR 4-FSK synth (wspr_modulator.rs)",
                       ("sample_rate",)),
    "underwater_acoustic_modem": ("underwater_modulate", "modulator",
                                  "slow shaped FSK "
                                  "(underwater_acoustic_modem.rs)",
                                  ("f0", "f1", "baud")),
    "powerline_carrier_modem": ("plc_modulate", "modulator",
                                "S-FSK PLC modem "
                                "(powerline_carrier_modem.rs)",
                                ("carriers_hz", "baud")),
    "rfid_backscatter_receiver": ("rfid_backscatter_decode",
                                  "demodulator",
                                  "FM0 backscatter decode "
                                  "(rfid_backscatter_receiver.rs)",
                                  ("blf_hz", "sample_rate")),
    "ambient_backscatter_processor": (
        "ambient_backscatter_detect", "demodulator",
        "envelope-level bit detect "
        "(ambient_backscatter_processor.rs)", ("frame",)),
    "vlc_modulator": ("vlc_modulate", "modulator",
                      "Manchester/VPPM intensity (vlc_modulator.rs)",
                      ("sps", "kind", "dimming")),
    "optical_coherent_receiver": ("coherent_optical_receive",
                                  "demodulator",
                                  "normalize + V&V phase recovery "
                                  "(optical_coherent_receiver.rs)",
                                  ("loop_bw",)),
    "wavelength_division_mux": ("wdm_mux", "modulator",
                                "comb multiplexing "
                                "(wavelength_division_mux.rs)",
                                ("spacing_cycles",)),
    "photonic_processing": ("photonic_mzi_transfer", "math",
                            "MZI transfer curve "
                            "(photonic_processing.rs)",
                            ("extinction_db",)),
    "dab_plus": ("dab_symbol_modulate", "modulator",
                 "DQPSK-OFDM DAB symbols (dab_plus.rs)",
                 ("n_carriers", "n_fft")),
    "drm_ofdm_processor": ("drm_ofdm_params", "modulator",
                           "DRM numerology (drm_ofdm_processor.rs)",
                           ("mode",)),
    "phasor_measurement_unit": ("pmu_phasor", "measurement",
                                "synchrophasor amp/phase/freq "
                                "(phasor_measurement_unit.rs)",
                                ("sample_rate", "f_nominal")),
    "power_line_harmonic_analyzer": (
        "harmonics_analyze", "measurement",
        "harmonic amplitudes + THD "
        "(power_line_harmonic_analyzer.rs)", ("f0", "n_harmonics")),
    "power_quality_event_classifier": (
        "power_quality_classify", "measurement",
        "sag/swell/interruption events "
        "(power_quality_event_classifier.rs)", ("f0",)),
    "photovoltaic_mppt_controller": ("mppt_perturb_observe", "math",
                                     "P&O MPPT step "
                                     "(photovoltaic_mppt_"
                                     "controller.rs)", ("v_step",)),
    "ev_motor_commutation": ("bldc_commutation", "math",
                             "six-step BLDC sectors "
                             "(ev_motor_commutation_controller.rs)",
                             ("pole_pairs",)),
    "industrial_process_modulation": (
        "industrial_4_20ma_encode", "modulator",
        "4-20 mA process encoding "
        "(industrial_process_modulation.rs)", ("lo", "hi")),
    "quantum_key_distribution": ("bb84_sift", "fec",
                                 "BB84 sifting + QBER "
                                 "(quantum_key_distribution.rs)",
                                 ("n_bits", "error_rate")),
}
