"""Polar code on tensors: the Arikan kernel's encoder and the
successive-cancellation decoder.

PyTorch counterpart of ``r4w_tpu.fec.polar``. Encoding is log2(N)
butterfly stages of XORs over the leading axes of frames. The frozen-bit
selection (`frozen_mask`, the Bhattacharyya heuristic) and the SC decoder
(`_f`, `_g`, `_sc_decode`, `_reencode`), which is sequential bit by bit,
run on the host in numpy in the reference too and are copied from it;
`polar_decode` takes a tensor or an array and returns numpy bits, as the
reference does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import SYMBOL_DTYPE, to_tensor


@functools.lru_cache(maxsize=None)
def frozen_mask(n: int, k: int, design_snr_db: float = 0.0) -> np.ndarray:
    """True where the channel is frozen (N-K worst Bhattacharyya)."""
    assert n & (n - 1) == 0
    snr = 10.0 ** (design_snr_db / 10.0)
    z = np.array([np.exp(-snr)])
    while len(z) < n:
        z = np.concatenate([2 * z - z**2, z**2])
    order = np.argsort(z)  # ascending Z = most reliable first
    frozen = np.ones(n, bool)
    frozen[order[:k]] = False
    return frozen


def polar_encode(bits, n: int, k: int, design_snr_db: float = 0.0) -> torch.Tensor:
    """(..., k) info bits -> (..., n) int32 codewords via butterfly stages."""
    mask = frozen_mask(n, k, design_snr_db)
    bits = to_tensor(bits, SYMBOL_DTYPE)
    info = torch.from_numpy(np.nonzero(~mask)[0]).to(bits.device)
    u = torch.zeros((*bits.shape[:-1], n), dtype=SYMBOL_DTYPE, device=bits.device)
    u = u.index_copy(-1, info, bits)
    # x = u · F^{⊗log2(n)}: butterfly network
    x = u
    step = 1
    while step < n:
        x = x.reshape(*x.shape[:-1], -1, 2, step)
        x = torch.stack([x[..., 0, :] ^ x[..., 1, :], x[..., 1, :]], dim=-2)
        x = x.reshape(*u.shape[:-1], n)
        step *= 2
    return x


def _f(a, b):  # min-sum f
    return np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))


def _g(a, b, u):
    return b + (1 - 2 * u) * a


def _sc_decode(llr: np.ndarray, frozen: np.ndarray) -> np.ndarray:
    """Recursive SC decode of one codeword; returns u-domain bits."""
    n = len(llr)
    if n == 1:
        return np.array([0 if (frozen[0] or llr[0] >= 0) else 1], np.int32)
    half = n // 2
    a, b = llr[:half], llr[half:]
    u1 = _sc_decode(_f(a, b), frozen[:half])
    # partial re-encode of u1 to get its codeword contribution
    x1 = _reencode(u1)
    u2 = _sc_decode(_g(a, b, x1), frozen[half:])
    return np.concatenate([u1, u2])


def _reencode(u: np.ndarray) -> np.ndarray:
    n = len(u)
    x = u.copy()
    step = 1
    while step < n:
        x = x.reshape(-1, 2, step)
        x[:, 0, :] ^= x[:, 1, :]
        x = x.reshape(n)
        step *= 2
    return x


def polar_decode(llr, n: int, k: int, design_snr_db: float = 0.0):
    """(..., n) channel LLRs (positive = bit 0) -> (..., k) info bits."""
    mask = frozen_mask(n, k, design_snr_db)
    if isinstance(llr, torch.Tensor):
        llr = llr.cpu().numpy()
    llr_np = np.asarray(llr, np.float64)
    single = llr_np.ndim == 1
    frames = llr_np.reshape(-1, n)
    out = np.zeros((len(frames), k), np.int32)
    info_idx = np.nonzero(~mask)[0]
    for i, fr in enumerate(frames):
        u = _sc_decode(fr, mask)
        out[i] = u[info_idx]
    return out[0] if single else out.reshape(*llr_np.shape[:-1], k)
