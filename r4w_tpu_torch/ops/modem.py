"""Modem building blocks.

PyTorch counterpart of ``r4w_tpu.ops.modem``; so far the max-log-MAP soft
demapper and its hard decision, which the MIL-STD-188-110 receiver uses.
LLRs follow the library's convention: LLR > 0 means bit 0 is more likely.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE, to_tensor

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
