"""Linear block codes: repetition, extended Golay(24,12), generic matrix codes.

PyTorch counterpart of ``r4w_tpu.fec.block``. The reference writes the
GF(2) products as integer einsums mod 2; CUDA has no integer matrix
product, so here each is an elementwise int32 product summed over the
contracted axis (``dtype=torch.int32``), then mod 2. Golay decoding looks
the 12-bit syndrome up in the reference's syndrome table (built in numpy)
and corrects every error pattern of weight 3 or less. Functions follow
the device of a tensor input; numpy or lists go to `resolve_device(device)`.
"""

from __future__ import annotations

import functools
from itertools import combinations

import numpy as np
import torch

from r4w_tpu_torch.core.types import SYMBOL_DTYPE, to_tensor


def _int(x, device=None) -> torch.Tensor:
    return to_tensor(x, SYMBOL_DTYPE, None if isinstance(x, torch.Tensor) else device)


def _gf2_product(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """x (..., k) · m (k, n) mod 2, as a masked int32 sum over k."""
    mat = torch.from_numpy(np.ascontiguousarray(m, np.int32)).to(x.device)
    return torch.sum(x[..., :, None] * mat, dim=-2, dtype=SYMBOL_DTYPE) % 2


# --------------------------------------------------------------------------
# Repetition code
# --------------------------------------------------------------------------


def repetition_encode(bits, n: int = 3, device=None) -> torch.Tensor:
    return _int(bits, device).repeat_interleave(n, dim=-1)


def repetition_decode(bits, n: int = 3, device=None) -> torch.Tensor:
    b = _int(bits, device)
    k = b.shape[-1] // n
    groups = b[..., : k * n].reshape(*b.shape[:-1], k, n)
    return (torch.sum(groups, dim=-1, dtype=SYMBOL_DTYPE) * 2 > n).to(SYMBOL_DTYPE)


# --------------------------------------------------------------------------
# Extended binary Golay (24, 12, 8)
# --------------------------------------------------------------------------

# B matrix (12x12) of G = [I | B], the classic circulant-plus-border form
_GOLAY_B = np.array([
    [1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 0, 1],
    [1, 0, 1, 1, 1, 0, 0, 0, 1, 0, 1, 1],
    [0, 1, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1],
    [1, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1],
    [1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1, 0, 1],
    [0, 1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 1],
    [1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1],
    [0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 1],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0],
], np.int32)


@functools.lru_cache(maxsize=None)
def _golay_syndrome_table() -> np.ndarray:
    """12-bit syndrome -> 24-bit error pattern (weight <= 3), packed."""
    h = np.concatenate([_GOLAY_B.T % 2, np.eye(12, dtype=np.int32)], axis=1)
    # H = [B^T | I], codeword c = [data | parity], syndrome = H c^T
    table = np.zeros(1 << 12, np.int64)
    found = np.zeros(1 << 12, bool)
    cols = h.T  # (24, 12): column j = syndrome of a single error at bit j

    def syn_of(positions):
        s = np.zeros(12, np.int32)
        for p in positions:
            s ^= cols[p]
        return int("".join(map(str, s)), 2)

    for w in range(4):
        for pos in combinations(range(24), w):
            s = syn_of(pos)
            if not found[s]:
                found[s] = True
                pat = 0
                for p in pos:
                    pat |= 1 << p
                table[s] = pat
    return table


@functools.lru_cache(maxsize=None)
def _syndrome_lut(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_golay_syndrome_table().astype(np.int32)).to(device)


def golay_encode(data12, device=None) -> torch.Tensor:
    """(..., 12) data bits -> (..., 24) codeword [data | parity]."""
    d = _int(data12, device)
    return torch.cat([d, _gf2_product(d, _GOLAY_B)], dim=-1)


def golay_decode(codeword24, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 24) -> ((..., 12) data, (...,) n_corrected): corrects every
    error pattern of weight <= 3 through the syndrome table."""
    c = _int(codeword24, device)
    data, parity = c[..., :12], c[..., 12:]
    syn_bits = (_gf2_product(data, _GOLAY_B) + parity) % 2  # B^T d + p
    weights = torch.from_numpy(1 << np.arange(11, -1, -1, dtype=np.int32)).to(c.device)
    syn = torch.sum(syn_bits * weights, dim=-1, dtype=SYMBOL_DTYPE)
    pattern = _syndrome_lut(c.device)[syn.long()]  # packed 24-bit error pattern
    err_bits = (pattern[..., None] >> torch.arange(24, dtype=SYMBOL_DTYPE, device=c.device)) & 1
    corrected = (c + err_bits) % 2
    return corrected[..., :12], torch.sum(err_bits, dim=-1, dtype=SYMBOL_DTYPE)


# --------------------------------------------------------------------------
# Generic linear block code over GF(2)
# --------------------------------------------------------------------------


def matrix_encode(data, generator: np.ndarray, device=None) -> torch.Tensor:
    """c = d·G (mod 2)."""
    return _gf2_product(_int(data, device), np.asarray(generator))


def syndrome(received, parity_check: np.ndarray, device=None) -> torch.Tensor:
    """s = H·r^T (mod 2)."""
    return _gf2_product(_int(received, device), np.asarray(parity_check).T)
