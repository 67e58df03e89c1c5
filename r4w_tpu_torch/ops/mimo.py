"""Diversity, MIMO and link-adaptation blocks: Alamouti, MRC/EGC/selection
combining, two-user SIC, waterfilling, adaptive modcod and UWB ranging.

PyTorch counterpart of ``r4w_tpu.ops.mimo`` (mimo.rs, alamouti_codec.rs,
antenna_diversity_combiner.rs, successive_interference_canceller.rs,
waterfilling.rs, adaptive_modcod.rs, ultra_wideband_ranging.rs). Combining
is elementwise over symbol pairs and branches; `selection_combine` gathers
the strongest branch (``take_along_axis``); `waterfilling` is exact by one
sort, every candidate water level from one cumulative sum (accumulated in
float64, as the port's cumulative sums are). `ModCod`, the default ladder
and `AdaptiveModcod` are host tables, copied as they are.
"""

from __future__ import annotations

import dataclasses

import torch

from r4w_tpu_torch.core.hostio import complex_abs, magnitude
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor

# ----------------------------------------------------------- Alamouti


def alamouti_encode(symbols) -> torch.Tensor:
    """2×1 STBC (alamouti_codec.rs): pairs (s0, s1) -> antenna streams
    [[s0, −s1*], [s1, s0*]] over two symbol times. Input (..., 2K); output
    (..., 2, 2K)."""
    s = to_tensor(symbols, IQ_DTYPE)
    pairs = s.reshape(*s.shape[:-1], -1, 2)
    s0, s1 = pairs[..., 0], pairs[..., 1]
    ant0 = torch.stack([s0, -torch.conj(s1)], dim=-1).reshape(*s.shape[:-1], -1)
    ant1 = torch.stack([s1, torch.conj(s0)], dim=-1).reshape(*s.shape[:-1], -1)
    return torch.stack([ant0, ant1], dim=-2)


def alamouti_decode(rx, h) -> torch.Tensor:
    """Combine a 2×1 Alamouti block: rx (..., 2K) at one receive antenna,
    h (..., 2) the channel [h0, h1], static over the block. Returns the
    symbol estimates (..., 2K) with full two-branch diversity."""
    rx = to_tensor(rx, IQ_DTYPE)
    h = to_tensor(h, IQ_DTYPE, device=rx.device)
    r = rx.reshape(*rx.shape[:-1], -1, 2)
    r0, r1 = r[..., 0], r[..., 1]
    h0, h1 = h[..., 0:1], h[..., 1:2]
    norm = complex_abs(h0) ** 2 + complex_abs(h1) ** 2
    s0 = (torch.conj(h0) * r0 + h1 * torch.conj(r1)) / norm
    s1 = (torch.conj(h1) * r0 - h0 * torch.conj(r1)) / norm
    return torch.stack([s0, s1], dim=-1).reshape(*rx.shape[:-1], -1)


# ---------------------------------------------------------- combining


def mrc_combine(rx, h) -> torch.Tensor:
    """Maximum-ratio combining over receive branches
    (antenna_diversity_combiner.rs): rx (..., B, N), h (..., B)."""
    h = to_tensor(h, IQ_DTYPE)
    num = torch.sum(torch.conj(h)[..., None] * to_tensor(rx, IQ_DTYPE, device=h.device), dim=-2)
    den = torch.sum(complex_abs(h) ** 2, dim=-1)[..., None]
    return num / torch.clamp(den, min=1e-12)


def egc_combine(rx, h) -> torch.Tensor:
    """Equal-gain combining: co-phase, then average."""
    ph = to_tensor(h, IQ_DTYPE)
    ph = ph / torch.clamp(complex_abs(ph), min=1e-12)
    return torch.mean(torch.conj(ph)[..., None] * to_tensor(rx, IQ_DTYPE, device=ph.device),
                      dim=-2)


def selection_combine(rx, h) -> torch.Tensor:
    """Pick the strongest branch."""
    h = to_tensor(h)
    idx = torch.argmax(magnitude(h), dim=-1)
    rx = to_tensor(rx, IQ_DTYPE, device=h.device)
    sel = torch.gather(rx, -2, idx[..., None, None].expand(*idx.shape, 1, rx.shape[-1]))[..., 0, :]
    hsel = torch.gather(h.to(IQ_DTYPE), -1, idx[..., None])
    return sel * torch.conj(hsel) / torch.clamp(complex_abs(hsel) ** 2, min=1e-12)


# ---------------------------------------------------------------- SIC


def sic_decode(rx, constellation, gains) -> torch.Tensor:
    """Two-user power-domain successive interference cancellation
    (successive_interference_canceller.rs): decode the strong user,
    reconstruct, subtract, decode the weak user. rx (..., N) =
    g0·s0 + g1·s1 + n with g0 > g1. Returns indices (..., 2, N)."""
    rx = to_tensor(rx, IQ_DTYPE)
    con = to_tensor(constellation, IQ_DTYPE, device=rx.device)
    g = to_tensor(gains, REAL_DTYPE, device=rx.device)
    idx0 = torch.argmin(complex_abs(rx[..., None] - g[0] * con), dim=-1)
    resid = rx - g[0] * con[idx0]
    idx1 = torch.argmin(complex_abs(resid[..., None] - g[1] * con), dim=-1)
    return torch.stack([idx0, idx1], dim=-2).to(torch.int32)


# ------------------------------------------------------- waterfilling


def waterfilling(channel_gains, total_power: float, noise_power: float = 1.0) -> torch.Tensor:
    """Classic waterfilling power allocation (waterfilling.rs):
    p_i = max(0, μ − N/|h_i|²) with Σp_i = P, exact via one sort: every
    candidate water level from one cumulative sum over the sorted inverse
    gains, and μ* > inv for exactly the active channels."""
    g = to_tensor(channel_gains, REAL_DTYPE)
    dev = g.device
    inv = real_scalar(noise_power, dev) / torch.clamp(magnitude(g) ** 2, min=1e-18)
    inv_sorted = torch.sort(inv).values
    n = inv.shape[0]
    ranks = torch.arange(1, n + 1, device=dev)
    csum = torch.cumsum(inv_sorted.double(), dim=0).to(REAL_DTYPE)
    mu_k = (total_power + csum) / ranks.to(REAL_DTYPE)
    kstar = torch.amax(torch.where(mu_k > inv_sorted, ranks, 0))
    # total_power <= 0 leaves no valid level (kstar = 0): allocate nothing
    ks = torch.clamp(kstar, min=1)
    mu = (total_power + torch.index_select(csum, 0, (ks - 1).reshape(1))[0]) / ks.to(REAL_DTYPE)
    return torch.where(kstar > 0, torch.clamp(mu - inv, min=0.0), 0.0)


# ----------------------------------------------------- link adaptation


@dataclasses.dataclass(frozen=True)
class ModCod:
    name: str
    bits_per_symbol: float
    min_snr_db: float


DEFAULT_MODCOD_TABLE = (
    ModCod("BPSK-1/2", 0.5, 0.0),
    ModCod("QPSK-1/2", 1.0, 3.0),
    ModCod("QPSK-3/4", 1.5, 6.0),
    ModCod("16QAM-1/2", 2.0, 9.0),
    ModCod("16QAM-3/4", 3.0, 12.5),
    ModCod("64QAM-2/3", 4.0, 16.5),
    ModCod("64QAM-5/6", 5.0, 19.5),
)


class AdaptiveModcod:
    """SNR-driven MCS selection with hysteresis (adaptive_modcod.rs): step
    up only when the SNR exceeds the next threshold + margin, step down at
    once when below the current threshold."""

    def __init__(self, table=DEFAULT_MODCOD_TABLE, up_margin_db: float = 1.0):
        self.table = tuple(table)
        self.up_margin_db = up_margin_db
        self.index = 0

    @property
    def current(self) -> ModCod:
        return self.table[self.index]

    def update(self, snr_db: float) -> ModCod:
        while (self.index + 1 < len(self.table)
               and snr_db >= self.table[self.index + 1].min_snr_db + self.up_margin_db):
            self.index += 1
        while self.index > 0 and snr_db < self.table[self.index].min_snr_db:
            self.index -= 1
        return self.current


# -------------------------------------------------------- UWB ranging


def twr_range(t_round_s: float, t_reply_s: float) -> float:
    """Two-way ranging (ultra_wideband_ranging.rs): d = c·(t_round − t_reply)/2."""
    return 299_792_458.0 * (t_round_s - t_reply_s) / 2.0


def leading_edge_toa(cir, sample_rate: float, threshold_ratio: float = 0.2) -> torch.Tensor:
    """Leading-edge time of arrival on a channel impulse response: the first
    sample whose amplitude reaches threshold_ratio × peak (robust in NLOS,
    where argmax locks to a late strong reflection)."""
    p = magnitude(cir)
    over = p >= threshold_ratio * torch.amax(p, dim=-1, keepdim=True)
    idx = torch.argmax(over.to(torch.uint8), dim=-1)  # the first True
    return idx.to(REAL_DTYPE) / real_scalar(sample_rate, p.device)
