"""Modem building blocks.

PyTorch counterpart of ``r4w_tpu.ops.modem`` (constellation_soft_decoder.rs,
quadrature_demod.rs, frequency_modulator.rs, phase_modulator.rs,
differential.rs, diff_phasor.rs, cpm.rs, gmsk_modulator.rs,
msk_modulator.rs, sc_fdma.rs, papr_reduction.rs, cyclic_prefix.rs,
index_modulation_mapper.rs, fbmc_polyphase_mapper.rs,
nr_resource_grid_mapper.rs). LLRs follow the library's convention:
LLR > 0 means bit 0 is more likely. Samples are on the last axis; leading
axes are a batch wherever the reference's function allows one.

Host tables (the CPM phase pulse, the PHYDYAS prototype, the OQAM phase
map, the NR resource grid and its DMRS values, the combinations of index
modulation) are numpy copies of the reference's and equal its arrays bit
for bit. The reference's one-hot products for index modulation are a TPU
layout; here they are a scatter and a gather. The FBMC overlap-add sums
the overlapping half-symbols in ascending order from zero, as the
reference's scatter-add applies its updates, and never by `index_add_`.
Float cumulative sums accumulate in float64 (`filters._cumsum`), so the
card's phase equals the CPU's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from itertools import combinations

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE, resolve_device, to_tensor
from r4w_tpu_torch.ops.filters import _cumsum

_MASKED = 1e30  # distance added to points whose bit does not match


def soft_demap_llr(symbols, constellation, noise_var: float = 1.0,
                   bit_map=None) -> torch.Tensor:
    """Max-log-MAP bit LLRs.

    symbols (..., S) complex; constellation (M,) complex; bit_map (M, B)
    bits of each point (defaults to the natural binary index). Returns
    LLRs (..., S, B) float32: the least squared distance to a point whose
    bit is 1, minus the least to a point whose bit is 0.
    """
    sym = to_tensor(symbols, IQ_DTYPE)
    con = to_tensor(constellation, IQ_DTYPE, sym.device)
    m = con.shape[0]
    b = int(np.log2(m))
    if bit_map is None:
        bit_map = (np.arange(m)[:, None] >> np.arange(b - 1, -1, -1)) & 1
    bm = torch.as_tensor(np.asarray(bit_map), dtype=REAL_DTYPE, device=sym.device)  # (M, B)
    d2 = torch.abs(sym[..., None] - con) ** 2 / noise_var  # (..., S, M)
    d0 = torch.amin(d2[..., None] + _MASKED * bm, dim=-2)  # (..., S, B)
    d1 = torch.amin(d2[..., None] + _MASKED * (1.0 - bm), dim=-2)
    return d1 - d0


def hard_from_llr(llr) -> torch.Tensor:
    """LLR (> 0 means bit 0) to hard bits, int32."""
    return (to_tensor(llr) < 0).to(SYMBOL_DTYPE)


# ------------------------------------------------------ analog demod


def quadrature_demod(x, gain: float = 1.0) -> torch.Tensor:
    """FM discriminator y[n] = gain·arg(x[n]·conj(x[n-1])), y[0] = 0
    (quadrature_demod.rs)."""
    x = to_tensor(x, IQ_DTYPE)
    y = gain * torch.angle(x[..., 1:] * torch.conj(x[..., :-1]))
    return torch.cat([y.new_zeros(y.shape[:-1] + (1,)), y], dim=-1)


def frequency_modulate(msg, sensitivity: float) -> torch.Tensor:
    """VCO: exp(j·sensitivity·cumsum(msg)) (frequency_modulator.rs)."""
    m = to_tensor(msg, REAL_DTYPE)
    return cis(_cumsum(m) * sensitivity)


def phase_modulate(msg, sensitivity: float) -> torch.Tensor:
    """exp(j·sensitivity·msg) (phase_modulator.rs)."""
    return cis(sensitivity * to_tensor(msg, REAL_DTYPE))


# ------------------------------------------------------- differential


def differential_encode(bits) -> torch.Tensor:
    """d[n] = b[n] xor d[n-1], the parity of prefix sums (differential.rs)."""
    b = to_tensor(bits, torch.int32)
    return torch.cumsum(b, dim=-1, dtype=torch.int32) % 2


def differential_decode(bits) -> torch.Tensor:
    """Inverse of differential_encode."""
    d = to_tensor(bits, torch.int32)
    prev = torch.cat([d.new_zeros(d.shape[:-1] + (1,)), d[..., :-1]], dim=-1)
    return d ^ prev


def diff_phasor(x) -> torch.Tensor:
    """x[n]·conj(x[n-1]) (diff_phasor.rs), the DPSK demod front end."""
    x = to_tensor(x, IQ_DTYPE)
    return x[..., 1:] * torch.conj(x[..., :-1])


# --------------------------------------------------------------- CPM


def _phase_pulse(kind: str, sps: int, span: int, bt: float):
    """Integrated frequency pulse q(t), normalized to 1/2 at the end."""
    n = sps * span
    t = (np.arange(n) + 0.5) / sps  # symbol units
    if kind == "rect":  # LREC (CPFSK / MSK when span=1)
        g = np.ones(n)
    elif kind == "rc":  # raised cosine LRC
        g = 1.0 - np.cos(2 * np.pi * t / span)
    elif kind == "gaussian":  # GMSK
        from math import sqrt, log, pi

        sigma = sqrt(log(2.0)) / (2 * pi * bt)
        tt = t - span / 2.0
        erf = np.vectorize(__import__("math").erf)
        g = 0.5 * (erf((tt + 0.5) / (sigma * np.sqrt(2)))
                   - erf((tt - 0.5) / (sigma * np.sqrt(2))))
    else:
        raise ValueError(f"unknown CPM pulse {kind}")
    q = np.cumsum(g)
    return q / (2.0 * q[-1])  # q(inf) = 1/2


def _device_of(x, device=None) -> torch.device:
    """x's device for a tensor, else the named (or default) device."""
    return x.device if isinstance(x, torch.Tensor) and device is None else resolve_device(device)


def cpm_modulate(symbols, sps: int, h: float = 0.5, pulse: str = "rect",
                 span: int = 1, bt: float = 0.3, device=None) -> torch.Tensor:
    """Continuous-phase modulation (cpm.rs): phase(t) = 2πh Σ_k a_k q(t − kT).
    symbols in {-(M-1)..(M-1)} odd steps. pulse='rect' span=1 h=0.5 gives MSK
    (msk_modulator.rs); pulse='gaussian' gives GMSK (gmsk_modulator.rs).
    The phase is built in float64 on the host, as the reference builds it,
    and cast to float32 before the phasor, on the symbols' device (numpy
    symbols: `device`, default the card)."""
    dev = _device_of(symbols, device)
    if isinstance(symbols, torch.Tensor):
        symbols = symbols.cpu().numpy()
    a = np.asarray(symbols, np.float64)
    q = _phase_pulse(pulse, sps, span, bt)
    n_sym = a.shape[-1]
    # frequency-pulse view: phase increments per sample
    g = np.diff(np.concatenate([[0.0], q]))  # (sps*span,)
    up = np.zeros((*a.shape[:-1], n_sym * sps))
    up[..., ::sps] = a
    incr = np.apply_along_axis(
        lambda v: np.convolve(v, g)[: n_sym * sps], -1, up)
    phase = 2 * np.pi * h * np.cumsum(incr, axis=-1)
    return cis(torch.from_numpy(phase.astype(np.float32)).to(dev))


def _antipodal(bits) -> np.ndarray:
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    return 2 * np.asarray(bits, np.int32) - 1


def msk_modulate(bits, sps: int, device=None) -> torch.Tensor:
    """MSK = CPM(rect, h=1/2) over ±1 (msk_modulator.rs)."""
    return cpm_modulate(_antipodal(bits), sps, h=0.5, pulse="rect", span=1,
                        device=_device_of(bits, device))


def gmsk_modulate(bits, sps: int, bt: float = 0.3, span: int = 4, device=None) -> torch.Tensor:
    """GMSK (gmsk_modulator.rs): Gaussian-filtered MSK."""
    return cpm_modulate(_antipodal(bits), sps, h=0.5, pulse="gaussian", span=span, bt=bt,
                        device=_device_of(bits, device))


# ------------------------------------------------------------ SC-FDMA


def sc_fdma_modulate(symbols, n_fft: int, n_sc: int, cp_len: int,
                     start: int = 0) -> torch.Tensor:
    """DFT-spread OFDM uplink modulator (sc_fdma.rs): per block of n_sc
    data symbols: DFT -> map to subcarriers [start, start+n_sc) ->
    IFFT -> CP. symbols (..., B, n_sc) -> (..., B*(n_fft+cp_len))."""
    s = to_tensor(symbols, IQ_DTYPE)
    spread = torch.fft.fft(s, dim=-1) / np.sqrt(n_sc)
    grid = s.new_zeros(s.shape[:-1] + (n_fft,))
    grid[..., start:start + n_sc] = spread
    time = torch.fft.ifft(grid, dim=-1) * np.sqrt(n_fft)
    with_cp = torch.cat([time[..., n_fft - cp_len:], time], dim=-1)
    return with_cp.reshape(*s.shape[:-2], -1)


def sc_fdma_demodulate(samples, n_fft: int, n_sc: int, cp_len: int,
                       start: int = 0) -> torch.Tensor:
    """Inverse of sc_fdma_modulate -> (..., B, n_sc) symbol estimates."""
    x = to_tensor(samples, IQ_DTYPE)
    blk = n_fft + cp_len
    b = x.shape[-1] // blk
    x = x[..., : b * blk].reshape(*x.shape[:-1], b, blk)[..., cp_len:]
    grid = torch.fft.fft(x, dim=-1) / np.sqrt(n_fft)
    spread = grid[..., start:start + n_sc]
    return torch.fft.ifft(spread, dim=-1) * np.sqrt(n_sc)


# ---------------------------------------------------------------- PAPR


def papr_db(x) -> torch.Tensor:
    """Peak-to-average power ratio in dB (papr_reduction.rs metric)."""
    x = to_tensor(x, IQ_DTYPE)
    p = x.real ** 2 + x.imag ** 2
    return 10.0 * torch.log10(torch.amax(p, dim=-1)
                              / torch.clamp(torch.mean(p, dim=-1), min=1e-30))


def papr_reduce_clip_filter(x, clip_ratio_db: float = 3.0,
                            iterations: int = 2, nfft: int | None = None,
                            band: float = 0.5) -> torch.Tensor:
    """Iterative clipping-and-filtering PAPR reduction
    (papr_reduction.rs): soft-clip the envelope then lowpass in the
    frequency domain to confine clipping noise out of band."""
    x = to_tensor(x, IQ_DTYPE)
    n = x.shape[-1]
    nfft = nfft or n
    rms = torch.sqrt(torch.mean(x.real ** 2 + x.imag ** 2, dim=-1, keepdim=True))
    limit = rms * 10.0 ** (clip_ratio_db / 20.0)
    f = torch.fft.fftfreq(nfft, device=x.device, dtype=REAL_DTYPE)
    mask = (torch.abs(f) <= band / 2.0).to(REAL_DTYPE)
    y = x
    for _ in range(iterations):
        env = torch.sqrt(y.real ** 2 + y.imag ** 2 + 1e-30)
        y = torch.where(env > limit, y * (limit / env), y)
        spec = torch.fft.fft(y, nfft, dim=-1) * mask
        y = torch.fft.ifft(spec, dim=-1)[..., :n]
    return y.to(IQ_DTYPE)


# -------------------------------------------------------- cyclic prefix


def add_cyclic_prefix(blocks, cp_len: int) -> torch.Tensor:
    """(..., B, N) -> (..., B, N+cp) (cyclic_prefix.rs)."""
    b = to_tensor(blocks)
    return torch.cat([b[..., b.shape[-1] - cp_len:], b], dim=-1)


def remove_cyclic_prefix(blocks, cp_len: int) -> torch.Tensor:
    return to_tensor(blocks)[..., cp_len:]


# --------------------------------------------------- index modulation


def _combinations_table(n: int, k: int) -> np.ndarray:
    return np.asarray(list(combinations(range(n), k)), np.int32)


def _index_layout(n_sub: int, n_active: int, constellation, device):
    con = to_tensor(constellation, IQ_DTYPE, device)
    bps = int(np.log2(con.shape[0]))
    idx_bits = int(np.floor(math.log2(math.comb(n_sub, n_active))))
    combos = torch.from_numpy(_combinations_table(n_sub, n_active)[: 2 ** idx_bits]).to(device)
    return con, bps, idx_bits, combos


def _msb_weights(n: int, device) -> torch.Tensor:
    return 2 ** torch.arange(n - 1, -1, -1, dtype=torch.int32, device=device)


def index_modulation_map(bits, n_sub: int, n_active: int, constellation):
    """OFDM-IM mapper (index_modulation_mapper.rs): per block, the first
    log2(C(n_sub, n_active)) bits pick which subcarriers are active
    (combinatorial method), remaining bits pick the symbols.
    bits (..., B, k) -> ((..., B, n_sub) complex grid, (..., B, n_active)
    active subcarriers)."""
    b = to_tensor(bits, torch.int32)
    con, bps, idx_bits, combos = _index_layout(n_sub, n_active, constellation, b.device)
    k = idx_bits + n_active * bps
    if b.shape[-1] != k:
        raise ValueError(f"need {k} bits per block, got {b.shape[-1]}")
    w_idx = torch.sum(b[..., :idx_bits] * _msb_weights(idx_bits, b.device), dim=-1)
    active = combos[w_idx]  # (..., n_active)
    sym_bits = b[..., idx_bits:].reshape(*b.shape[:-1], n_active, bps)
    sym_idx = torch.sum(sym_bits * _msb_weights(bps, b.device), dim=-1)
    grid = con.new_zeros(b.shape[:-1] + (n_sub,))
    grid.scatter_(-1, active.long(), con[sym_idx])
    return grid, active


def index_modulation_demap(grid, n_sub: int, n_active: int,
                           constellation) -> torch.Tensor:
    """ML OFDM-IM demapper: pick the legal active-set with the most
    energy (the first on ties), then nearest-point demap the symbols on it.
    Returns bits (..., idx_bits + n_active*log2(M))."""
    g = to_tensor(grid, IQ_DTYPE)
    con, bps, idx_bits, combos = _index_layout(n_sub, n_active, constellation, g.device)
    p = g.real ** 2 + g.imag ** 2  # (..., n_sub)
    # each legal set's energy, its members summed in subcarrier order
    members = p[..., combos.long()]  # (..., W, A)
    energy = members[..., 0]
    for a in range(1, n_active):
        energy = energy + members[..., a]
    w_idx = torch.argmax(energy, dim=-1)
    active = combos[w_idx]  # (..., A)
    picked = torch.gather(g, -1, active.long())
    d2 = torch.abs(picked[..., None] - con) ** 2
    sym_idx = torch.argmin(d2, dim=-1)
    shifts_i = torch.arange(idx_bits - 1, -1, -1, device=g.device)
    shifts_s = torch.arange(bps - 1, -1, -1, device=g.device)
    ib = (w_idx[..., None] >> shifts_i) & 1
    sb = (sym_idx[..., None] >> shifts_s) & 1
    return torch.cat([ib, sb.reshape(*sb.shape[:-2], -1)], dim=-1).to(SYMBOL_DTYPE)


# --------------------------------------------------------------------------
# FBMC/OQAM polyphase mapper (fbmc_polyphase_mapper.rs re-design)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def phydyas_filter(n_subcarriers: int, overlap: int = 4) -> np.ndarray:
    """PHYDYAS prototype filter, length K·M, unit energy
    (fbmc_polyphase_mapper.rs:78)."""
    m, k = n_subcarriers, overlap
    length = k * m
    if k == 2:
        coeffs = [1.0, 1.0 / np.sqrt(2.0)]
    elif k == 3:
        coeffs = [1.0, 0.911438, 0.411438]
    elif k == 4:
        coeffs = [1.0, 0.971960, 0.707107, 0.235147]
    else:
        coeffs = [1.0] + [np.sinc(i / k) for i in range(1, k)]
    n = np.arange(length) - (length - 1) / 2.0
    h = np.full(length, coeffs[0])
    for i in range(1, len(coeffs)):
        h = h + 2.0 * coeffs[i] * np.cos(2.0 * np.pi * i * n / length)
    return (h / np.sqrt(np.sum(h * h))).astype(np.float32)


def oqam_stagger(qam) -> torch.Tensor:
    """QAM (..., T, M) → OQAM real half-symbols (..., 2T, M): real parts
    then imaginary parts per symbol period
    (fbmc_polyphase_mapper.rs:138)."""
    qam = to_tensor(qam, IQ_DTYPE)
    return torch.stack([qam.real, qam.imag], dim=-2).reshape(
        *qam.shape[:-2], 2 * qam.shape[-2], qam.shape[-1])


def oqam_destagger(oqam) -> torch.Tensor:
    """Inverse of oqam_stagger: (..., 2T, M) → (..., T, M) complex."""
    x = to_tensor(oqam, REAL_DTYPE)
    t2, m = x.shape[-2], x.shape[-1]
    pairs = x.reshape(*x.shape[:-2], t2 // 2, 2, m)
    return torch.complex(pairs[..., 0, :], pairs[..., 1, :])


def _fbmc_theta(t_half: int, m: int) -> np.ndarray:
    """OQAM phase map θ[t, n] = j^(n+t) keeping adjacent REs in
    quadrature."""
    n = np.arange(m)
    t = np.arange(t_half)[:, None]
    return np.power(1j, (n[None, :] + t) % 4).astype(np.complex64)


def fbmc_modulate(oqam, overlap: int = 4) -> torch.Tensor:
    """FBMC/OQAM synthesis: per half-symbol IFFT × PHYDYAS prototype,
    overlap-added at M/2 spacing (fbmc_polyphase_mapper.rs:330
    FbmcModulator::modulate).

    oqam: (T2, M) real half-symbols. Returns ((T2-1)·M/2 + K·M,) IQ. The
    output is cut into blocks of M/2; half-symbol t covers blocks t ..
    t + 2K − 1, and each block sums its half-symbols in ascending t from
    zero (one slice-add per position j in a half-symbol's 2K blocks, taken
    from the last to the first), the order of the reference's scatter-add.
    """
    oqam = to_tensor(oqam, REAL_DTYPE)
    t2, m = oqam.shape
    k, half = overlap, m // 2
    if m % 2:
        raise ValueError(f"FBMC needs an even subcarrier count, got {m}")
    dev = oqam.device
    proto = torch.from_numpy(phydyas_filter(m, k)).to(dev)
    theta = torch.from_numpy(_fbmc_theta(t2, m)).to(dev)
    freq = oqam.to(IQ_DTYPE) * theta  # (T2, M)
    base = torch.fft.ifft(freq, dim=-1) * m  # (T2, M)
    ext = base.repeat(1, k) * proto[None, :]  # (T2, K·M)
    parts = ext.reshape(t2, 2 * k, half)
    blocks = ext.new_zeros((t2 - 1 + 2 * k, half))
    for j in range(2 * k - 1, -1, -1):
        blocks[j:j + t2] += parts[:, j]
    return blocks.reshape(-1)


def fbmc_demodulate(x, n_subcarriers: int, n_half_symbols: int,
                    overlap: int = 4) -> torch.Tensor:
    """FBMC/OQAM analysis: matched prototype filtering + FFT + phase
    derotation, real part (FbmcDemodulator::demodulate). Perfect-
    reconstruction up to the PHYDYAS intrinsic interference on the
    imaginary axis, which OQAM discards. Reads past the end clamp to the
    last sample, as the reference's gather does."""
    x = to_tensor(x, IQ_DTYPE)
    m, k, t2 = n_subcarriers, overlap, n_half_symbols
    dev = x.device
    proto = torch.from_numpy(phydyas_filter(m, k)).to(dev)
    idx = (torch.arange(t2, device=dev)[:, None] * (m // 2)
           + torch.arange(k * m, device=dev)[None, :])
    segs = x[torch.clamp(idx, max=x.shape[-1] - 1)] * proto[None, :]  # (T2, KM)
    parts = segs.reshape(t2, k, m)
    folded = parts[:, 0]
    for i in range(1, k):  # alias-fold to M
        folded = folded + parts[:, i]
    freq = torch.fft.fft(folded, dim=-1) / m
    theta = torch.from_numpy(_fbmc_theta(t2, m)).to(dev)
    return (freq * torch.conj(theta)).real


def fbmc_spectral_efficiency(n_subcarriers: int, overlap: int) -> float:
    """OQAM carries one real symbol per subcarrier per half period — same
    asymptotic efficiency as CP-free OFDM (fbmc_polyphase_mapper.rs:194)."""
    del n_subcarriers, overlap
    return 1.0


# --------------------------------------------------------------------------
# 5G NR resource grid mapper (nr_resource_grid_mapper.rs re-design)
# --------------------------------------------------------------------------

NR_RE_GUARD, NR_RE_DATA, NR_RE_DMRS, NR_RE_PTRS = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class NrGridConfig:
    """5G NR slot grid (nr_resource_grid_mapper.rs:119 NrConfig +
    SlotConfig). numerology μ∈0..4 → SCS 15·2^μ kHz; normal CP = 14
    symbols/slot, extended (μ=2 only) = 12."""

    numerology: int = 0
    num_prbs: int = 6
    num_symbols: int = 14
    slot_number: int = 0
    frame_number: int = 0
    dmrs_symbols: tuple[int, ...] = (2, 3)  # Type A, additional pos 1
    ptrs_density: int = 0  # 0 = off; else every Nth subcarrier

    @property
    def num_subcarriers(self) -> int:
        return 12 * self.num_prbs

    @property
    def subcarrier_spacing_khz(self) -> float:
        return 15.0 * (2 ** self.numerology)

    @property
    def slot_duration_ms(self) -> float:
        return 1.0 / (2 ** self.numerology)


@functools.lru_cache(maxsize=None)
def nr_re_types(cfg: NrGridConfig) -> np.ndarray:
    """(num_symbols, num_subcarriers) int8 resource-type map: DMRS comb-2
    on the configured symbols, optional PTRS columns, DATA elsewhere."""
    grid = np.full((cfg.num_symbols, cfg.num_subcarriers), NR_RE_DATA,
                   np.int8)
    for sym in cfg.dmrs_symbols:
        if sym < cfg.num_symbols:
            grid[sym, 0::2] = NR_RE_DMRS
            grid[sym, 1::2] = NR_RE_GUARD  # comb-2 companion REs unused
    if cfg.ptrs_density > 0:
        for sym in range(cfg.num_symbols):
            if sym in cfg.dmrs_symbols:
                continue
            grid[sym, 0::cfg.ptrs_density] = NR_RE_PTRS
    return grid


@functools.lru_cache(maxsize=None)
def nr_dmrs_values(cfg: NrGridConfig) -> np.ndarray:
    """Deterministic QPSK DMRS sequence seeded by slot/frame
    (nr_resource_grid_mapper.rs:255 dmrs_sequence_value)."""
    types = nr_re_types(cfg)
    vals = np.zeros(types.shape, np.complex64)
    sym_idx, sc_idx = np.nonzero(types == NR_RE_DMRS)
    seed = ((cfg.frame_number * 131 + cfg.slot_number) * 97
            + sc_idx) * 53 + sym_idx
    phase = (seed % 4) * np.pi / 2.0 + np.pi / 4.0
    vals[sym_idx, sc_idx] = (np.cos(phase) + 1j * np.sin(phase)) / np.sqrt(2)
    return vals


def nr_data_capacity(cfg: NrGridConfig) -> int:
    return int((nr_re_types(cfg) == NR_RE_DATA).sum())


def _positions(cfg: NrGridConfig, kind: int, device) -> torch.Tensor:
    return torch.from_numpy(np.nonzero(nr_re_types(cfg).reshape(-1) == kind)[0]).to(device)


def nr_map(data_symbols, cfg: NrGridConfig = NrGridConfig()) -> torch.Tensor:
    """Map data symbols onto the slot grid around DMRS/PTRS
    (insert_dmrs + map_pdsch_data roles). data_symbols: (..., D) with
    D <= nr_data_capacity(cfg), zero-padded when shorter. Returns
    (..., num_symbols, num_subcarriers) complex grid."""
    types = nr_re_types(cfg)
    d = to_tensor(data_symbols, IQ_DTYPE)
    dev = d.device
    cap = nr_data_capacity(cfg)
    assert d.shape[-1] <= cap, (d.shape, cap)
    flat = d.new_zeros(d.shape[:-1] + (types.size,))
    data_pos = _positions(cfg, NR_RE_DATA, dev)
    flat[..., data_pos[: d.shape[-1]]] = d
    dmrs_pos = _positions(cfg, NR_RE_DMRS, dev)
    dmrs_vals = torch.from_numpy(nr_dmrs_values(cfg).reshape(-1)).to(dev)[dmrs_pos]
    flat[..., dmrs_pos] = dmrs_vals
    ptrs_pos = _positions(cfg, NR_RE_PTRS, dev)
    if ptrs_pos.numel():
        flat[..., ptrs_pos] = torch.tensor((1.0 + 1.0j) / np.sqrt(2.0), dtype=IQ_DTYPE,
                                           device=dev)
    return flat.reshape(d.shape[:-1] + types.shape)


def nr_demap(grid, cfg: NrGridConfig = NrGridConfig()) -> torch.Tensor:
    """Extract the data REs in mapping order (extract_data role)."""
    g = to_tensor(grid, IQ_DTYPE)
    flat = g.reshape(*g.shape[:-2], -1)
    return flat[..., _positions(cfg, NR_RE_DATA, g.device)]
