"""Symbol mapping and composed modems.

PyTorch counterpart of ``r4w_tpu.ops.mapping`` (symbol_mapping.rs,
symbol_demapper.rs, symbol_slicer.rs, chunks_to_symbols.rs,
constellation_encoder.rs, constellation_receiver.rs, map_bb.rs,
oqpsk_modulator.rs, qam_modem_transceiver.rs, ssb_modem.rs, am_demod.rs,
fm_receiver.rs, fm_stereo_decoder.rs, rds_decoder.rs,
soft_decision_decoder.rs, log_likelihood_ratio.rs, pilot_inserter.rs,
ofdm_carrier_allocator.rs, ofdm_resource_mapper.rs,
subcarrier_allocator.rs, multicarrier_allocation.rs,
crest_factor_reduction.rs, peak_to_average.rs, incoherent_detector.rs,
regenerate_bb.rs, vector_quantizer.rs).

Constellations come from the port's `waveforms.linear_mod`; mapping is
one gather and demapping one argmin over |x − point|², with |·| the
reference's compiled `abs` (`core.hostio.complex_abs`), so decisions are
the reference's and the card's are the CPU's. The broadcast FM chain
(`fm_receiver`, `fm_stereo_decode`, `rds_subcarrier_demod`) runs its
FIRs on `kernels.fir` (one launch a filter on the card) and its
de-emphasis on `kernels.recurrence` (one launch). The RDS symbol positions
are computed in float32, as the reference computes them: at a minute of
samples float64 would pick other samples. Divisions by a sample rate are
by a float32 tensor (`real_scalar`), the quotient the reference rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.ops import filters as _filters
from r4w_tpu_torch.ops import filters2 as _filters2
from r4w_tpu_torch.ops import modem as _modem
from r4w_tpu_torch.ops.events import refractory_trigger
from r4w_tpu_torch.ops.sync import _integer_pow
from r4w_tpu_torch.waveforms import linear_mod as _lm

# ----------------------------------------------------- symbol mapping


def constellation_table(name: str, device=None) -> torch.Tensor:
    """Shared constellation lookup (constellation_encoder.rs):
    'bpsk'/'qpsk'/'8psk'/'qam16'/'qam64'/'qam256'."""
    name = name.lower()
    if name in ("bpsk", "qpsk", "8psk"):
        order = {"bpsk": 2, "qpsk": 4, "8psk": 8}[name]
        return to_tensor(_lm.psk_constellation(order), IQ_DTYPE, device)
    if name.startswith("qam"):
        return to_tensor(_lm.qam_constellation(int(name[3:])), IQ_DTYPE, device)
    raise ValueError(f"unknown constellation '{name}'")


def _table(constellation, like: torch.Tensor) -> torch.Tensor:
    return to_tensor(constellation, IQ_DTYPE, like.device)


def _operand(x, dtype, constellation) -> torch.Tensor:
    """x as a tensor of `dtype`: on its own device if a tensor, else on the
    constellation's if that is one, else on the default device."""
    if not isinstance(x, torch.Tensor) and isinstance(constellation, torch.Tensor):
        return to_tensor(x, dtype, constellation.device)
    return to_tensor(x, dtype)


def symbol_map(indices, constellation) -> torch.Tensor:
    """Index → point gather (symbol_mapping.rs / chunks_to_symbols.rs)."""
    idx = _operand(indices, torch.int64, constellation)
    return _table(constellation, idx)[idx]


def _distances(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return complex_abs(x[..., None] - table)


def symbol_demap(x, constellation) -> torch.Tensor:
    """Nearest-point hard demapping (symbol_demapper.rs): one argmin
    over the squared distances (the first point on ties)."""
    x = _operand(x, IQ_DTYPE, constellation)
    d = _distances(x, _table(constellation, x)) ** 2
    return torch.argmin(d, dim=-1).to(torch.int32)


def symbol_slicer(x, kind: str = "qpsk") -> torch.Tensor:
    """Quadrant/axis hard slicer (symbol_slicer.rs) — decision without
    a table for the common constellations."""
    x = to_tensor(x, IQ_DTYPE)
    if kind == "bpsk":
        return (x.real < 0).to(torch.int32)
    if kind == "qpsk":
        return (x.real < 0).to(torch.int32) * 2 + (x.imag < 0).to(torch.int32)
    raise ValueError(f"unknown slicer kind '{kind}'")


def chunks_to_symbols(bits, constellation, bits_per_symbol: int) -> torch.Tensor:
    """Bit groups → constellation points (chunks_to_symbols.rs)."""
    b = _operand(bits, torch.int32, constellation)
    n = (b.shape[0] // bits_per_symbol) * bits_per_symbol
    groups = b[:n].reshape(-1, bits_per_symbol)
    weights = 1 << torch.arange(bits_per_symbol - 1, -1, -1, dtype=torch.int32, device=b.device)
    idx = torch.sum(groups * weights[None, :], dim=-1, dtype=torch.int32)
    return symbol_map(idx, constellation)


def map_bb(x, table) -> torch.Tensor:
    """Byte → byte lookup mapping (map_bb.rs)."""
    x = _operand(x, torch.int64, table)
    return to_tensor(table, torch.int32, x.device)[x]


def constellation_receiver(x, constellation):
    """Hard decisions + quality metrics (constellation_receiver.rs):
    returns (indices, evm_rms, min_distance_margin)."""
    x = _operand(x, IQ_DTYPE, constellation)
    table = _table(constellation, x)
    d = _distances(x, table)
    idx = torch.argmin(d, dim=-1)
    err = x - table[idx]
    evm = torch.sqrt(torch.mean(complex_abs(err) ** 2) / torch.mean(complex_abs(table) ** 2))
    d_sorted = torch.sort(d, dim=-1).values
    margin = torch.mean(d_sorted[..., 1] - d_sorted[..., 0])
    return idx.to(torch.int32), evm, margin


def soft_decision_decode(llrs):
    """LLR → (hard bits, confidence) (soft_decision_decoder.rs /
    log_likelihood_ratio.rs consumer). Positive LLR convention = bit 0."""
    llr = to_tensor(llrs, REAL_DTYPE)
    return (llr < 0).to(torch.int32), torch.tanh(torch.abs(llr) / 2.0)


def vector_quantize(x, codebook):
    """Nearest-codeword VQ encode/decode (vector_quantizer.rs).
    x: (N, D), codebook: (K, D). Returns (indices, reconstruction)."""
    x = _operand(x, REAL_DTYPE, codebook)
    cb = to_tensor(codebook, REAL_DTYPE, x.device)
    d = torch.sum((x[:, None, :] - cb[None, :, :]) ** 2, dim=-1)
    idx = torch.argmin(d, dim=-1)
    return idx.to(torch.int32), cb[idx]


# ------------------------------------------------------ OQPSK & modems


def oqpsk_modulate(bits, sps: int = 4) -> torch.Tensor:
    """Offset-QPSK (oqpsk_modulator.rs): Q delayed by half a symbol —
    constant-envelope transitions (no zero crossings)."""
    b = to_tensor(bits, torch.int32)
    n = (b.shape[0] // 2) * 2
    i_bits = 2.0 * b[0:n:2].to(REAL_DTYPE) - 1.0
    q_bits = 2.0 * b[1:n:2].to(REAL_DTYPE) - 1.0
    i_up = torch.repeat_interleave(i_bits, sps)
    q_up = torch.repeat_interleave(q_bits, sps)
    pad = i_up.new_zeros((sps // 2,))
    return torch.complex(torch.cat([i_up, pad]), torch.cat([pad, q_up])) / np.sqrt(2)


def oqpsk_demodulate(x, sps: int = 4) -> torch.Tensor:
    """Sample I at symbol centers and Q a half-symbol later."""
    x = to_tensor(x, IQ_DTYPE)
    half = sps // 2
    n_sym = (x.shape[0] - half) // sps
    i_idx = torch.arange(n_sym, device=x.device) * sps + sps // 2
    i_bits = (x.real[i_idx] > 0).to(torch.int32)
    q_bits = (x.imag[i_idx + half] > 0).to(torch.int32)
    return torch.stack([i_bits, q_bits], dim=-1).reshape(-1)


def qam_transceiver(bits, m: int, snr_db: float | None = None, key=None):
    """Composed QAM TX→(AWGN)→RX convenience (qam_modem_transceiver.rs).
    `key` is a `channel.threefry` key: the reference's noise for it.
    Returns (tx_symbols, rx_bits)."""
    b = to_tensor(bits, torch.int32)
    k = int(np.log2(m))
    table = constellation_table(f"qam{m}", b.device)
    tx = chunks_to_symbols(b, table, k)
    rx = tx
    if snr_db is not None and key is not None:
        from r4w_tpu_torch.channel import awgn
        rx = awgn(tx, snr_db, key=key)
    idx = symbol_demap(rx, table)
    shifts = torch.arange(k - 1, -1, -1, dtype=torch.int32, device=b.device)
    return tx, ((idx[:, None] >> shifts[None, :]) & 1).reshape(-1)


# --------------------------------------------------------- analog demod


def am_demod(x, coherent: bool = False, carrier_removal: float = 0.999) -> torch.Tensor:
    """AM demodulation (am_demod.rs): envelope (noncoherent) or
    real-part (coherent), with DC block for the carrier bias."""
    x = to_tensor(x, IQ_DTYPE)
    audio = x.real if coherent else complex_abs(x)
    y, _ = _filters.dc_blocker(audio.to(REAL_DTYPE), alpha=carrier_removal)
    return y


def _delayed(a: torch.Tensor, delay: int) -> torch.Tensor:
    """a delayed by `delay` samples along its last axis, zeros first."""
    return torch.cat([a.new_zeros(a.shape[:-1] + (delay,)), a], dim=-1)[..., : a.shape[-1]]


def ssb_modulate(audio, sample_rate: float, upper: bool = True,
                 n_taps: int = 129) -> torch.Tensor:
    """SSB via the Hilbert (phasing) method (ssb_modem.rs):
    analytic = audio + j·H{audio}; USB keeps positive freqs, LSB the
    conjugate."""
    a = to_tensor(audio, REAL_DTYPE)
    q = _filters.fir_apply(_filters.hilbert_fir_taps(n_taps), a)
    return torch.complex(_delayed(a, (n_taps - 1) // 2), q if upper else -q)


def ssb_demodulate(x) -> torch.Tensor:
    """Coherent SSB product detector: take the real part (carrier
    already at DC in the complex-baseband representation)."""
    return to_tensor(x, IQ_DTYPE).real.to(REAL_DTYPE)


def fm_receiver(x, sample_rate: float, deviation_hz: float = 75_000.0,
                audio_rate: float | None = None, deemph_us: float = 75.0) -> torch.Tensor:
    """Broadcast-FM receive chain (fm_receiver.rs): quadrature demod →
    de-emphasis → audio decimate."""
    x = to_tensor(x, IQ_DTYPE)
    demod = _modem.quadrature_demod(x, gain=sample_rate / (2.0 * np.pi * deviation_hz))
    audio = _filters2.fm_deemphasis(demod, sample_rate, deemph_us)
    if audio_rate is not None:
        decim = max(1, int(round(sample_rate / audio_rate)))
        taps = _filters.design_lowpass(101, audio_rate / 2.0, sample_rate)
        audio = _filters.fir_apply(taps, audio)[..., ::decim]
    return audio


def _analytic_bandpass(m: torch.Tensor, f_lo: float, f_hi: float, sample_rate: float,
                       n_taps: int = 301):
    """Analytic (positive-frequency) bandpass: complex taps
    2·lp[n]·exp(jω_c(n−(N−1)/2)); group delay (N−1)/2 like the real
    prototype, so the delayed input stays phase-aligned."""
    f_c = 0.5 * (f_lo + f_hi)
    lp = np.asarray(_filters.design_lowpass(n_taps, (f_hi - f_lo) / 2.0, sample_rate),
                    np.float64)
    nvec = np.arange(n_taps) - (n_taps - 1) / 2.0
    taps = (2.0 * lp * np.exp(2j * np.pi * f_c * nvec / sample_rate)).astype(np.complex64)
    analytic = torch.complex(_filters.fir_apply(np.ascontiguousarray(taps.real), m),
                             _filters.fir_apply(np.ascontiguousarray(taps.imag), m))
    delay = (n_taps - 1) // 2
    return analytic, _delayed(m, delay), delay


def fm_stereo_decode(mpx, sample_rate: float):
    """Stereo MPX decode (fm_stereo_decoder.rs): L+R baseband; the
    38 kHz carrier for the L−R DSB-SC subband is regenerated by
    squaring the ANALYTIC 19 kHz pilot (phase-exact — a squared real
    pilot lands 90° off the standard's in-phase 2nd harmonic).
    Returns (left, right, pilot_present)."""
    m = to_tensor(mpx, REAL_DTYPE)
    p_hat, m_del, _ = _analytic_bandpass(m, 18_500.0, 19_500.0, sample_rate)
    present = torch.mean(complex_abs(p_hat) ** 2) > 2e-6
    # pilot = sin(θ) → analytic = -j·A·e^{jθ}; squared = -A²e^{j2θ};
    # the standard's in-phase subcarrier sin(2θ) = -Im(p̂²)/A².
    sq = p_hat * p_hat
    carrier38 = -sq.imag / torch.clamp(complex_abs(sq), min=1e-12)
    lp = _filters.design_lowpass(201, 15_000.0, sample_rate)
    sum_ch = _filters.fir_apply(lp, m_del)
    diff_raw = _filters.fir_apply(lp, 2.0 * m_del * carrier38)
    return (sum_ch + diff_raw) / 2.0, (sum_ch - diff_raw) / 2.0, present


def rds_symbol_positions(n: int, sample_rate: float, total_delay: int,
                         device=None) -> torch.Tensor:
    """The samples `rds_subcarrier_demod` reads: symbol k at
    int(float32(k)·float32(sps)) + int(sps/2) + total_delay, the product
    rounded to float32 as the reference rounds it."""
    sps = sample_rate / 1187.5
    n_sym = int((n - total_delay) / sps) - 2
    idx = (torch.arange(n_sym, dtype=REAL_DTYPE, device=device) * sps).to(torch.int32)
    return idx + (int(sps / 2) + total_delay)


def rds_subcarrier_demod(mpx, sample_rate: float):
    """Recover the 57 kHz RDS BPSK subcarrier and return the 1187.5 bps
    differential-decoded bit stream (rds_decoder.rs physical layer).

    Carrier: cube of the ANALYTIC 19 kHz pilot (3×19k = 57 kHz, phase
    locked); both quadratures are formed and the stronger one is used;
    the residual BPSK polarity ambiguity cancels in the differential
    decode. Symbol timing from the known 1187.5 Hz rate."""
    m = to_tensor(mpx, REAL_DTYPE)
    n = m.shape[0]
    p_hat, m_del, bp_delay = _analytic_bandpass(m, 18_700.0, 19_300.0, sample_rate)
    c3 = _integer_pow(p_hat, 3)
    c3 = c3 / torch.clamp(complex_abs(c3), min=1e-12)  # unit e^{j(3θ+φ0)}
    z = m_del * torch.conj(c3)
    n_lp = 301
    lp = _filters.design_lowpass(n_lp, 2_400.0, sample_rate)
    zi = _filters.fir_apply(lp, z.real.contiguous())
    zq = _filters.fir_apply(lp, z.imag.contiguous())
    use_q = torch.mean(zq ** 2) > torch.mean(zi ** 2)
    soft = torch.where(use_q, zq, zi)
    # total group delay of the soft stream vs the input MPX
    idx = rds_symbol_positions(n, sample_rate, bp_delay + (n_lp - 1) // 2, m.device)
    bits = (soft[idx] > 0).to(torch.int32)
    # differential decode (RDS is differentially encoded); global
    # polarity flips cancel here
    return torch.cat([bits[:1], bits[1:] ^ bits[:-1]]), soft


# ----------------------------------------------------- OFDM allocation


def ofdm_carrier_allocate(data_syms, n_fft: int, occupied, pilots,
                          pilot_value: complex = 1.0 + 0.0j) -> torch.Tensor:
    """Place data + pilots onto an OFDM symbol grid
    (ofdm_carrier_allocator.rs / ofdm_resource_mapper.rs /
    subcarrier_allocator.rs). occupied/pilots are carrier index lists
    (negative = below DC). Returns (n_syms, n_fft) grids."""
    data = to_tensor(data_syms, IQ_DTYPE)
    dev = data.device
    occ = torch.from_numpy(np.asarray(occupied, np.int64) % n_fft).to(dev)
    pil = torch.from_numpy(np.asarray(pilots, np.int64) % n_fft).to(dev)
    per = occ.shape[0]
    n_syms = -(-data.shape[0] // per)
    padded = torch.cat([data, data.new_zeros((n_syms * per - data.shape[0],))])
    grid = data.new_zeros((n_syms, n_fft))
    grid[:, occ] = padded.reshape(n_syms, per)
    grid[:, pil] = torch.tensor(pilot_value, dtype=IQ_DTYPE, device=dev)
    return grid


def ofdm_carrier_deallocate(grid, occupied) -> torch.Tensor:
    g = to_tensor(grid)
    occ = torch.from_numpy(np.asarray(occupied, np.int64) % g.shape[-1]).to(g.device)
    return g[..., occ].reshape(-1)


def multicarrier_waterfill(channel_gains, total_power: float,
                           noise_power: float = 1.0) -> torch.Tensor:
    """Water-filling power allocation across subcarriers
    (multicarrier_allocation.rs): bisection on the water level, a fixed
    50 iterations on the device."""
    g = to_tensor(channel_gains, REAL_DTYPE)
    inv = noise_power / torch.clamp(g, min=1e-12)
    lo = g.new_zeros(())
    hi = torch.amax(inv) + total_power
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        over = torch.sum(torch.clamp(mid - inv, min=0.0)) > total_power
        hi = torch.where(over, mid, hi)
        lo = torch.where(over, lo, mid)
    return torch.clamp(0.5 * (lo + hi) - inv, min=0.0)


def pilot_insert(symbols, pilot, period: int) -> torch.Tensor:
    """Insert a pilot symbol every ``period`` data symbols
    (pilot_inserter.rs)."""
    s = to_tensor(symbols, IQ_DTYPE)
    n = (s.shape[0] // period) * period
    blocks = s[:n].reshape(-1, period)
    p = torch.full((blocks.shape[0], 1), complex(pilot), dtype=IQ_DTYPE, device=s.device)
    return torch.cat([torch.cat([p, blocks], dim=1).reshape(-1), s[n:]])


# ------------------------------------------------------------- PAPR/CFR


def peak_to_average(x) -> torch.Tensor:
    """PAPR in dB (peak_to_average.rs → modem.papr_db)."""
    return _modem.papr_db(x)


def crest_factor_reduce(x, clip_ratio_db: float = 3.0, iterations: int = 3) -> torch.Tensor:
    """Iterative clip-and-filter CFR (crest_factor_reduction.rs →
    modem.papr_reduce_clip_filter)."""
    return _modem.papr_reduce_clip_filter(x, clip_ratio_db, iterations=iterations)


# ---------------------------------------------------------- detectors


def tone_basis(freqs_hz, sample_rate: float, length: int, device) -> torch.Tensor:
    """(M, L) conjugate tones cis(−2π·f·t), t = n/fs, in the reference's
    float32 order: (−2π·f)·t."""
    t = torch.arange(length, dtype=REAL_DTYPE, device=device) / real_scalar(sample_rate, device)
    f = to_tensor(freqs_hz, REAL_DTYPE, device)
    return cis(-2.0 * np.pi * f[:, None] * t[None, :])


def incoherent_detect(x, freqs_hz, sample_rate: float, sym_len: int):
    """Noncoherent M-FSK detection (incoherent_detector.rs): per-symbol
    energy at each candidate tone via one (sym, tone) product (FP32, no
    TF32); the first tone on ties."""
    x = to_tensor(x, IQ_DTYPE)
    n_sym = x.shape[0] // sym_len
    frames = x[:n_sym * sym_len].reshape(n_sym, sym_len)
    basis = tone_basis(freqs_hz, sample_rate, sym_len, x.device)  # (M, L)
    energy = complex_abs(frames @ basis.T) ** 2  # (n_sym, M)
    return torch.argmax(energy, dim=-1).to(torch.int32), energy


def regenerate_bb(trigger, period: int, width: int, n: int) -> torch.Tensor:
    """Regenerate clean pulses from (possibly jittered) trigger events
    (regenerate_bb.rs): each trigger starts a clean width-``width``
    pulse; retriggers within ``period`` are ignored."""
    trig = to_tensor(trigger).to(torch.bool)
    # refractory acceptance, then paint width-long pulses by comparing each
    # sample to the most recent accepted trigger index (a running max)
    acc = refractory_trigger(trig, period)
    t_idx = torch.arange(trig.shape[0], device=trig.device)
    last = torch.cummax(torch.where(acc, t_idx, torch.full_like(t_idx, -period - width)),
                        dim=0).values
    out = ((t_idx - last) < width).to(torch.int32)
    if n <= trig.shape[0]:
        return out[:n]
    return torch.cat([out, out.new_zeros((n - trig.shape[0],))])


BLOCKS = {
    "constellation_encoder": ("constellation_table", "modulator",
                              "shared constellation tables "
                              "(constellation_encoder.rs)", ("name",)),
    "symbol_mapping": ("symbol_map", "modulator",
                       "index->point gather (symbol_mapping.rs)"),
    "symbol_demapper": ("symbol_demap", "demodulator",
                        "nearest-point demap (symbol_demapper.rs)"),
    "symbol_slicer": ("symbol_slicer", "demodulator",
                      "axis slicer (symbol_slicer.rs)", ("kind",)),
    "chunks_to_symbols": ("chunks_to_symbols", "modulator",
                          "bit groups -> points (chunks_to_symbols.rs)",
                          ("bits_per_symbol",)),
    "map_bb": ("map_bb", "math", "byte LUT mapping (map_bb.rs)"),
    "constellation_receiver": ("constellation_receiver", "demodulator",
                               "decisions + EVM + margin "
                               "(constellation_receiver.rs)"),
    "soft_decision_decoder": ("soft_decision_decode", "fec",
                              "LLR -> bits+confidence "
                              "(soft_decision_decoder.rs)"),
    "log_likelihood_ratio": ("soft_decision_decode", "fec",
                             "LLR consumer (log_likelihood_ratio.rs; "
                             "producer = modem.soft_demap_llr)"),
    "vector_quantizer": ("vector_quantize", "math",
                         "nearest-codeword VQ (vector_quantizer.rs)"),
    "oqpsk_modulator": ("oqpsk_modulate", "modulator",
                        "offset-QPSK (oqpsk_modulator.rs)", ("sps",)),
    "qam_modem_transceiver": ("qam_transceiver", "modulator",
                              "composed QAM TX/RX "
                              "(qam_modem_transceiver.rs)", ("m",)),
    "am_demod": ("am_demod", "demodulator",
                 "envelope/coherent AM (am_demod.rs)", ("coherent",)),
    "ssb_modem": ("ssb_modulate", "modulator",
                  "Hilbert-method SSB (ssb_modem.rs)", ("upper",)),
    "fm_receiver": ("fm_receiver", "demodulator",
                    "quad demod + deemph + decimate (fm_receiver.rs)",
                    ("sample_rate", "deviation_hz")),
    "fm_stereo_decoder": ("fm_stereo_decode", "demodulator",
                          "19k pilot MPX stereo (fm_stereo_decoder.rs)",
                          ("sample_rate",)),
    "rds_decoder": ("rds_subcarrier_demod", "demodulator",
                    "57 kHz RDS BPSK subcarrier (rds_decoder.rs)",
                    ("sample_rate",)),
    "ofdm_carrier_allocator": ("ofdm_carrier_allocate", "modulator",
                               "data+pilot grid placement "
                               "(ofdm_carrier_allocator.rs)",
                               ("n_fft", "occupied", "pilots")),
    "ofdm_resource_mapper": ("ofdm_carrier_deallocate", "demodulator",
                             "grid -> data extraction "
                             "(ofdm_resource_mapper.rs)", ("occupied",)),
    "subcarrier_allocator": ("multicarrier_waterfill", "math",
                             "water-filling power allocation "
                             "(subcarrier_allocator.rs / "
                             "multicarrier_allocation.rs)",
                             ("total_power",)),
    "pilot_inserter": ("pilot_insert", "modulator",
                       "periodic pilot insertion (pilot_inserter.rs)",
                       ("pilot", "period")),
    "peak_to_average": ("peak_to_average", "measurement",
                        "PAPR dB (peak_to_average.rs)"),
    "crest_factor_reduction": ("crest_factor_reduce", "modulator",
                               "clip-and-filter CFR "
                               "(crest_factor_reduction.rs)",
                               ("target_papr_db",)),
    "incoherent_detector": ("incoherent_detect", "demodulator",
                            "noncoherent M-FSK energy detector "
                            "(incoherent_detector.rs)",
                            ("freqs_hz", "sample_rate", "sym_len")),
    "regenerate_bb": ("regenerate_bb", "math",
                      "clean pulse regeneration (regenerate_bb.rs)",
                      ("period", "width")),
}
