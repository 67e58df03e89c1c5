"""DVB-S2X LDPC codec on tensors.

PyTorch counterpart of ``r4w_tpu.fec.dvb_s2x``: the DVB-S2X frame
structure (the 11 code rates, Normal 64,800 / Short 16,200 coded-bit
frames, systematic IRA staircase parity) over the reference's
deterministic pseudo-random information-column placement, not the ETSI
address tables. `CODE_RATES`, `FRAME_BITS`, `info_bits` and
`parity_structure` (the uint64 LCG) are numpy and copied from the
reference. Encoding is an integer scatter of the information bits onto
their check rows and a prefix XOR for the staircase; decoding is
normalised min-sum on the masked (checks × largest row degree) layout,
batched over leading axes of frames, through `fec.ldpc.min_sum`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, SYMBOL_DTYPE, to_tensor
from r4w_tpu_torch.fec.ldpc import Tanner, min_sum, tanner

CODE_RATES = {
    "1/4": 0.25, "1/3": 1 / 3, "2/5": 0.4, "1/2": 0.5, "3/5": 0.6,
    "2/3": 2 / 3, "3/4": 0.75, "4/5": 0.8, "5/6": 5 / 6,
    "8/9": 8 / 9, "9/10": 0.9,
}

FRAME_BITS = {"normal": 64800, "short": 16200}

# information-column weight per rate (dvb_s2x_ldpc_codec.rs:178-186)
_INFO_COL_WEIGHT = {
    "1/4": 6, "1/3": 6, "2/5": 5, "1/2": 5, "3/5": 4, "2/3": 4,
    "3/4": 4, "4/5": 4, "5/6": 3, "8/9": 3, "9/10": 3,
}

_RATE_SEED = {r: 100 * (i + 1) for i, r in enumerate(
    ["1/4", "1/3", "2/5", "1/2", "3/5", "2/3", "3/4", "4/5", "5/6",
     "8/9", "9/10"])}
_SIZE_SEED = {"normal": 0xDEAD0000, "short": 0xBEEF0000}

_LCG_MUL = np.uint64(6364136223846793005)
_LCG_ADD = np.uint64(1442695040888963407)


def info_bits(rate: str, frame: str = "short") -> int:
    """k for (rate, frame) (dvb_s2x_ldpc_codec.rs:139)."""
    return int(round(FRAME_BITS[frame] * CODE_RATES[rate]))


@functools.lru_cache(maxsize=None)
def parity_structure(rate: str, frame: str = "short"):
    """Deterministic sparse H in edge-list form.

    Returns dict with:
      k, n, m — dimensions;
      info_rows, info_cols — (E,) arrays: row/col of each info-column 1;
      edge_col, edge_mask — (m, dc_max) dense decoder layout covering
      info AND staircase parity columns.
    The construction mirrors generate_parity_check: each info column j
    gets `info_col_weight` distinct rows from an LCG seeded by
    (j, rate, size) with linear-probe collision resolution; parity
    columns form the dual-diagonal staircase.
    """
    n = FRAME_BITS[frame]
    k = info_bits(rate, frame)
    m = n - k
    w = _INFO_COL_WEIGHT[rate]

    # vectorized LCG draw of w rows per info column; duplicate rows
    # within a column (rare, ~w²/2m) are linear-probed sequentially
    with np.errstate(over="ignore"):
        seeds = (np.arange(k, dtype=np.uint64) * np.uint64(2654435761)
                 + np.uint64(_RATE_SEED[rate])
                 + np.uint64(_SIZE_SEED[frame]))
        draws = np.empty((k, w), np.int64)
        s = seeds
        for t in range(w):
            s = s * _LCG_MUL + _LCG_ADD
            draws[:, t] = (s >> np.uint64(16)).astype(np.int64) % m
    rows_per_col = draws
    srt = np.sort(draws, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    for j in np.nonzero(dup)[0]:
        assigned: list[int] = []
        for row in draws[j]:
            row = int(row)
            while row in assigned:
                row = (row + 1) % m
            assigned.append(row)
        rows_per_col[j] = assigned

    info_rows = rows_per_col.reshape(-1)
    info_cols = np.repeat(np.arange(k, dtype=np.int64), w)

    # decoder layout: group all edges (info + staircase) by row
    all_rows = np.concatenate([
        info_rows,
        np.arange(m),                       # diagonal parity col k+i
        np.arange(1, m),                    # sub-diagonal parity col k+i-1
    ])
    all_cols = np.concatenate([
        info_cols,
        k + np.arange(m),
        k + np.arange(m - 1),
    ])
    order = np.argsort(all_rows, kind="stable")
    r_sorted, c_sorted = all_rows[order], all_cols[order]
    deg = np.bincount(r_sorted, minlength=m)
    dc_max = int(deg.max())
    edge_col = np.zeros((m, dc_max), np.int32)
    edge_mask = np.zeros((m, dc_max), bool)
    pos = np.zeros(m, np.int64)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(len(r_sorted)) - starts[r_sorted]
    edge_col[r_sorted, slot] = c_sorted
    edge_mask[r_sorted, slot] = True
    del pos
    return dict(k=k, n=n, m=m, info_rows=info_rows, info_cols=info_cols,
                edge_col=edge_col, edge_mask=edge_mask)


class Structure(NamedTuple):
    """A `parity_structure` on a device: dimensions, the information
    columns' check rows and columns (E,) int64, and the decoder's layout."""
    k: int
    n: int
    m: int
    info_rows: torch.Tensor
    info_cols: torch.Tensor
    layout: Tanner


def structure_on(st: dict, device) -> Structure:
    """A `parity_structure` dict (the port's or the reference's) on `device`."""
    as_long = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
    return Structure(int(st["k"]), int(st["n"]), int(st["m"]), as_long(st["info_rows"]),
                     as_long(st["info_cols"]), tanner(st["edge_col"], st["edge_mask"],
                                                      int(st["n"]), device))


@functools.lru_cache(maxsize=None)
def device_structure(rate: str, frame: str, device: torch.device) -> Structure:
    """`structure_on(parity_structure(rate, frame), device)`, cached."""
    return structure_on(parity_structure(rate, frame), device)


def encode(bits, rate: str = "1/2", frame: str = "short") -> torch.Tensor:
    """Systematic encode (..., k) -> (..., n) int32: codeword = [u | p] with
    staircase parity p_i = p_{i-1} ⊕ (H_info·u)_i, in int32 sums."""
    u = to_tensor(bits, SYMBOL_DTYPE)
    st = device_structure(rate, frame, u.device)
    if u.shape[-1] != st.k:
        raise ValueError(f"{rate} {frame} frames carry k = {st.k} bits, got {u.shape[-1]}")
    syn = torch.zeros((*u.shape[:-1], st.m), dtype=SYMBOL_DTYPE, device=u.device)
    syn.index_add_(-1, st.info_rows, u.index_select(-1, st.info_cols))
    parity = torch.cumsum(syn, dim=-1, dtype=SYMBOL_DTYPE) % 2  # prefix XOR
    return torch.cat([u, parity], dim=-1)


def decode(llr, rate: str = "1/2", frame: str = "short", iters: int = 25,
           alpha: float = 0.8):
    """Normalised min-sum decode of channel LLRs (..., n), positive = bit 0.

    Returns (information bits (..., k) int32, parity_ok (...,) bool)."""
    llr = to_tensor(llr, REAL_DTYPE)
    st = device_structure(rate, frame, llr.device)
    if llr.shape[-1] != st.n:
        raise ValueError(f"{rate} {frame} frames have n = {st.n} bits, got {llr.shape[-1]}")
    hard = (min_sum(llr, st.layout, iters, alpha) < 0).to(SYMBOL_DTYPE)
    row_bits = torch.where(st.layout.edge_mask,
                           hard.index_select(-1, st.layout.edge_col.reshape(-1))
                           .reshape(*hard.shape[:-1], *st.layout.edge_col.shape), 0)
    ok = torch.all(row_bits.sum(-1, dtype=SYMBOL_DTYPE) % 2 == 0, dim=-1)
    return hard[..., : st.k], ok
