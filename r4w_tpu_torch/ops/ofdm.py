"""OFDM channel estimation and equalisation.

PyTorch counterpart of ``r4w_tpu.ops.ofdm``. A packet of OFDM symbols is
one (..., n_sym, n_bins) tensor: least-squares estimates at every pilot
of every symbol in one gather, the common phase error per symbol by a
reduction, the packet's channel by a masked mean, and the interpolation
over the band by the host-built (n_bins, n_pilots) linear-interpolation
matrix. The reference applies that matrix as a float32 matmul to the
real and imaginary parts; here it is an elementwise product summed over
the pilots, so no TF32 or reduced-precision matmul can touch it.
Functions follow the device of a tensor input; numpy or lists go to
`resolve_device(device)`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor


def _iq(x, device=None) -> torch.Tensor:
    return to_tensor(x, IQ_DTYPE, None if isinstance(x, torch.Tensor) else device)


def _const(values, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class PilotPattern:
    """Pilot layout within the occupied-subcarrier vector.

    Positions index into the occupied (data + pilot) subcarriers, not raw
    FFT bins; values are the known transmitted pilot points.
    """

    positions: tuple[int, ...]
    values: tuple[complex, ...]
    n_occupied: int

    def __post_init__(self):
        if len(self.positions) != len(self.values):
            raise ValueError("one value per pilot position")
        if not all(0 <= p < self.n_occupied for p in self.positions):
            raise ValueError("pilot positions must lie in the occupied band")

    @classmethod
    def uniform(cls, n_occupied: int, spacing: int,
                value: complex = 1.0 + 0.0j) -> "PilotPattern":
        """Every `spacing`-th occupied subcarrier is a pilot."""
        pos = tuple(range(0, n_occupied, spacing))
        return cls(pos, (value,) * len(pos), n_occupied)

    @classmethod
    def edges_and_uniform(cls, n_occupied: int, n_pilots: int,
                          value: complex = 1.0 + 0.0j) -> "PilotPattern":
        """n_pilots spread evenly including both band edges, so the
        interpolation never extrapolates across the occupied band."""
        if n_pilots < 2:
            raise ValueError("need at least two pilots")
        pos = tuple(int(round(i * (n_occupied - 1) / (n_pilots - 1))) for i in range(n_pilots))
        return cls(pos, (value,) * n_pilots, n_occupied)

    @property
    def num_pilots(self) -> int:
        return len(self.positions)

    @property
    def num_data(self) -> int:
        return self.n_occupied - self.num_pilots

    @functools.cached_property
    def data_positions(self) -> np.ndarray:
        mask = np.ones(self.n_occupied, bool)
        mask[list(self.positions)] = False
        return np.nonzero(mask)[0]


@functools.lru_cache(maxsize=None)
def _interp_operator(positions: tuple[int, ...], n_bins: int) -> np.ndarray:
    """(n_bins, n_pilots) linear-interpolation matrix, H_full = W @ H_pilots:
    linear between adjacent pilots, the nearest pilot outside them."""
    pos = np.asarray(positions, np.float64)
    w = np.zeros((n_bins, len(positions)), np.float32)
    for b in range(n_bins):
        j = np.searchsorted(pos, b)
        if j == 0:
            w[b, 0] = 1.0
        elif j == len(pos):
            w[b, -1] = 1.0
        elif pos[j] == b:
            w[b, j] = 1.0
        else:
            frac = (b - pos[j - 1]) / (pos[j] - pos[j - 1])
            w[b, j - 1] = 1.0 - frac
            w[b, j] = frac
    return w


def _positions(pattern: PilotPattern, like: torch.Tensor) -> torch.Tensor:
    return _const(np.asarray(pattern.positions, np.int64), torch.int64, like)


def estimate_pilot_ls(rx_occupied, pattern: PilotPattern, device=None) -> torch.Tensor:
    """Least-squares channel at each pilot of each symbol:
    H_ls[..., s, p] = rx[..., s, pos_p] / pilot_value_p."""
    rx_occupied = _iq(rx_occupied, device)
    vals = _const(np.asarray(pattern.values, np.complex64), IQ_DTYPE, rx_occupied)
    return rx_occupied[..., _positions(pattern, rx_occupied)] / vals


def common_phase_error(h_ls, h_ref) -> torch.Tensor:
    """Per-symbol unit phasor of the pilot estimates' rotation against a
    reference estimate; a zero correlation gives 1."""
    corr = torch.sum(h_ls * torch.conj(h_ref), dim=-1)
    mag = torch.abs(corr)
    degen = (mag <= 1e-12).to(REAL_DTYPE)
    scale = (1.0 - degen) / torch.clamp_min(mag, 1e-12)
    return torch.complex(corr.real * scale + degen, corr.imag * scale)


def interpolate(h_pilots: torch.Tensor, pattern: PilotPattern) -> torch.Tensor:
    """(..., n_pilots) -> (..., n_occupied): `_interp_operator` applied to
    the real and imaginary parts as a product summed over the pilots."""
    w = _const(_interp_operator(pattern.positions, pattern.n_occupied), REAL_DTYPE, h_pilots)
    re = torch.sum(h_pilots.real[..., None, :] * w, dim=-1)
    im = torch.sum(h_pilots.imag[..., None, :] * w, dim=-1)
    return torch.complex(re, im)


def estimate_channel(rx_occupied, pattern: PilotPattern, device=None):
    """Packet channel over the occupied band, block fading up to a
    per-symbol common phase error. Returns (h_occ (..., n_occupied),
    cpe (..., n_sym) unit phasors)."""
    h_ls = estimate_pilot_ls(rx_occupied, pattern, device)  # (..., S, P)
    # first-pass reference (CPE-biased), then derotate and re-average
    h0 = torch.mean(h_ls, dim=-2, keepdim=True)
    cpe = common_phase_error(h_ls, h0)  # (..., S)
    h_pkt = torch.mean(h_ls * torch.conj(cpe)[..., None], dim=-2)  # (..., P)
    return interpolate(h_pkt, pattern), cpe


def equalize_zf(rx, h, floor: float = 1e-6, device=None) -> torch.Tensor:
    """Zero forcing: rx/h with a floor on |h|²."""
    rx = _iq(rx, device)
    p = torch.clamp_min(torch.abs(h) ** 2, floor)
    return rx * torch.conj(h) / p


def equalize_mmse(rx, h, noise_var, device=None) -> torch.Tensor:
    """MMSE: rx·conj(h)/(|h|²+σ²)."""
    rx = _iq(rx, device)
    noise_var = torch.as_tensor(noise_var, dtype=REAL_DTYPE, device=rx.device)
    return rx * torch.conj(h) / (torch.abs(h) ** 2 + noise_var)


def _residual_noise_var(h_ls, cpe, h_at_pilots) -> torch.Tensor:
    resid = h_ls * torch.conj(cpe)[..., None] - h_at_pilots
    return torch.clamp_min(torch.mean(torch.abs(resid) ** 2, dim=(-2, -1)), 1e-6)[..., None, None]


def _equalize(derot, h_occ, method: str, noise_var) -> torch.Tensor:
    if method == "mmse":
        return equalize_mmse(derot, h_occ[..., None, :], noise_var)
    if method == "zf":
        return equalize_zf(derot, h_occ[..., None, :])
    raise ValueError(f"unknown equalizer method: {method}")


def equalize_frame(rx_occupied, pattern: PilotPattern, method: str = "mmse",
                   noise_var=None, device=None):
    """Estimate and equalise a whole packet from its pilots and strip them.

    rx_occupied: (..., n_sym, n_occupied) post-FFT occupied subcarriers.
    noise_var=None estimates σ² from the spread of the pilot residuals.
    Returns (data (..., n_sym, n_data), h_occ, cpe).
    """
    rx_occupied = _iq(rx_occupied, device)
    h_occ, cpe = estimate_channel(rx_occupied, pattern)
    derot = rx_occupied * torch.conj(cpe)[..., None]
    if noise_var is None:
        pos = _positions(pattern, rx_occupied)
        noise_var = _residual_noise_var(estimate_pilot_ls(rx_occupied, pattern), cpe,
                                        h_occ[..., None, pos])
    eq = _equalize(derot, h_occ, method, noise_var)
    data = eq[..., _const(pattern.data_positions, torch.int64, eq)]
    return data, h_occ, cpe


@functools.lru_cache(maxsize=None)
def training_sequence(n_occupied: int, seed: int = 0x1F) -> np.ndarray:
    """Known QPSK training symbol over the occupied band, from
    `np.random.default_rng(seed)` as the reference draws it."""
    rng = np.random.default_rng(seed)
    pts = (rng.integers(0, 2, n_occupied) * 2 - 1) + 1j * (rng.integers(0, 2, n_occupied) * 2 - 1)
    return (pts / np.sqrt(2.0)).astype(np.complex64)


def estimate_channel_from_training(rx_train, train_vals, device=None) -> torch.Tensor:
    """Per-bin LS channel from known training symbols: rx_train
    (..., T, n_occ) / train_vals (n_occ), averaged over T."""
    rx_train = _iq(rx_train, device)
    train_vals = _iq(train_vals, rx_train.device)
    return torch.mean(rx_train / train_vals, dim=-2)


def equalize_packet(rx_occupied, pattern: PilotPattern, train_vals, n_train: int,
                    method: str = "mmse", noise_var=None, device=None):
    """Full packet receive: the channel per bin from the training symbols,
    the common phase per symbol from the pilots, then MMSE or ZF.

    rx_occupied: (..., n_train + n_sym, n_occupied) post-FFT points,
    training symbols first. Returns (data (..., n_sym, n_data), h_occ, cpe).
    """
    rx_occupied = _iq(rx_occupied, device)
    train_vals = _iq(train_vals, rx_occupied.device)
    rx_train = rx_occupied[..., :n_train, :]
    rx_data = rx_occupied[..., n_train:, :]
    h_occ = estimate_channel_from_training(rx_train, train_vals)
    pos = _positions(pattern, rx_occupied)
    vals = _const(np.asarray(pattern.values, np.complex64), IQ_DTYPE, rx_occupied)
    h_ls = rx_data[..., pos] / vals  # (..., S, P)
    cpe = common_phase_error(h_ls, h_occ[..., None, pos])
    derot = rx_data * torch.conj(cpe)[..., None]
    if noise_var is None:
        noise_var = _residual_noise_var(h_ls, cpe, h_occ[..., None, pos])
    eq = _equalize(derot, h_occ, method, noise_var)
    data = eq[..., _const(pattern.data_positions, torch.int64, eq)]
    return data, h_occ, cpe


def channel_magnitude_db(h_occ) -> torch.Tensor:
    """Per-bin magnitude response in dB."""
    return 20.0 * torch.log10(torch.clamp_min(torch.abs(to_tensor(h_occ)), 1e-12))
