"""LDPC codes: the regular Gallager construction and normalised min-sum
decoding, on tensors.

PyTorch counterpart of ``r4w_tpu.fec.ldpc``. `make_regular_ldpc` is numpy
and copied from the reference. The decoder keeps the reference's dense
(checks × edges-per-check) message layout, batched over leading axes of
frames, and `min_sum` is shared with `fec.dvb_s2x`.

The messages into each variable are summed by a gather through a padded
variable → edge table (`Tanner.var_edges`) and adds in the table's order,
which is the order of the edges in the layout, as the reference's
scatter-add adds them. A scatter-add (``index_add_``) would sum float32
messages through atomics on the card, in an order that changes from run
to run, and near convergence that can flip a decision. Encoding and the
parity checks are integer sums in int32, never a float product.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, SYMBOL_DTYPE, to_tensor


@functools.lru_cache(maxsize=None)
def make_regular_ldpc(n: int = 96, dv: int = 3, dc: int = 6, seed: int = 1):
    """Regular (dv, dc) Gallager parity matrix H (m×n) + systematic G.

    Returns (H, G, k): G is (k, n) with columns permuted so encoding is
    c = u·G (mod 2) and H·cᵀ = 0.
    """
    assert (n * dv) % dc == 0
    m = n * dv // dc
    rng = np.random.default_rng(seed)
    while True:
        # permutation-based construction
        edges = np.repeat(np.arange(n), dv)
        rng.shuffle(edges)
        h = np.zeros((m, n), np.int8)
        ok = True
        for i, v in enumerate(edges):
            c = i % m
            if h[c, v]:
                ok = False
                break
            h[c, v] = 1
        if not ok:
            continue
        if np.any(h.sum(1) != dc) or np.any(h.sum(0) != dv):
            continue
        # gaussian elimination to find G
        hh = h.copy() % 2
        perm = np.arange(n)
        r = 0
        for col in range(n):
            if r >= m:
                break
            pivot = np.nonzero(hh[r:, col])[0]
            if len(pivot) == 0:
                continue
            p = pivot[0] + r
            hh[[r, p]] = hh[[p, r]]
            for row in range(m):
                if row != r and hh[row, col]:
                    hh[row] ^= hh[r]
            perm[[r, col]] = perm[[col, r]]  # not used; placeholder
            r += 1
        rank = r
        k = n - rank
        # recompute in systematic form: find column permutation putting
        # identity in front
        hh = h.copy() % 2
        cols = []
        r = 0
        used = np.zeros(n, bool)
        for col in range(n):
            if r >= m:
                break
            piv = np.nonzero(hh[r:, col])[0]
            if len(piv) == 0:
                continue
            p = piv[0] + r
            hh[[r, p]] = hh[[p, r]]
            for row in range(m):
                if row != r and hh[row, col]:
                    hh[row] ^= hh[r]
            cols.append(col)
            used[col] = True
            r += 1
        if r < m:
            continue  # rank-deficient; retry
        free_cols = np.nonzero(~used)[0]
        k = n - m
        # H in systematic-ish form: hh[:, cols] = I, hh[:, free] = P
        p_mat = hh[:, free_cols]  # (m, k)
        g = np.zeros((k, n), np.int8)
        g[np.arange(k), free_cols] = 1
        g[:, np.asarray(cols)] = p_mat.T
        assert not ((h @ g.T) % 2).any()
        return h.astype(np.int8), g.astype(np.int8), k, free_cols.astype(np.int32)


class Tanner(NamedTuple):
    """A decoder's edge layout on a device.

    `edge_col` (m, dc) is the variable of each check's edge slot and
    `edge_mask` (m, dc) which slots are edges; `var_edges` (n, dv) lists
    each variable's edges as flat indices into the (m·dc) layout in
    increasing order, padded with a slot that holds no edge (its message
    is always 0)."""
    edge_col: torch.Tensor
    edge_mask: torch.Tensor
    var_edges: torch.Tensor


def tanner(edge_col: np.ndarray, edge_mask: np.ndarray, n: int, device) -> Tanner:
    """The `Tanner` layout of (m, dc) `edge_col`/`edge_mask` over n variables.
    A column of empty slots is added when every slot is an edge and the
    variables' degrees differ, so the padding has a slot to point at."""
    edge_col, edge_mask = np.asarray(edge_col), np.asarray(edge_mask, bool)
    flat = np.nonzero(edge_mask.reshape(-1))[0]
    cols = edge_col.reshape(-1)[flat]
    deg = np.bincount(cols, minlength=n)
    if deg.min() != deg.max() and edge_mask.all():
        edge_col = np.pad(edge_col, ((0, 0), (0, 1)))
        edge_mask = np.pad(edge_mask, ((0, 0), (0, 1)))
        return tanner(edge_col, edge_mask, n, device)
    empty = int(np.argmin(edge_mask.reshape(-1))) if not edge_mask.all() else 0
    order = np.argsort(cols, kind="stable")  # by variable, edges in layout order
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    table = np.full((n, int(deg.max())), empty, np.int64)
    table[cols[order], np.arange(len(order)) - starts[cols[order]]] = flat[order]
    return Tanner(torch.from_numpy(edge_col.astype(np.int64)).to(device),
                  torch.from_numpy(edge_mask).to(device), torch.from_numpy(table).to(device))


def variable_sums(msg: torch.Tensor, layout: Tanner) -> torch.Tensor:
    """Σ of the check messages (..., m, dc) into each variable -> (..., n),
    added one edge at a time in `var_edges` order."""
    n, dv = layout.var_edges.shape
    flat = msg.reshape(*msg.shape[:-2], -1)
    g = flat.index_select(-1, layout.var_edges.reshape(-1)).reshape(*flat.shape[:-1], n, dv)
    sums = g[..., 0]
    for j in range(1, dv):
        sums = sums + g[..., j]
    return sums


def min_sum(llr: torch.Tensor, layout: Tanner, iters: int, alpha: float) -> torch.Tensor:
    """`iters` iterations of normalised min-sum from zero messages; returns
    the beliefs (..., n) = llr + Σ messages. Per check: the product of the
    other edges' signs (0 counts as +) times alpha times the least other
    magnitude (the least of all where it is tied); a check with one edge
    sends nothing. Empty slots hold 0."""
    m, dc = layout.edge_col.shape
    gather = layout.edge_col.reshape(-1)
    mask = layout.edge_mask
    msg = torch.zeros((*llr.shape[:-1], m, dc), dtype=REAL_DTYPE, device=llr.device)
    coef = float(np.float32(alpha))
    for _ in range(iters):
        belief = llr + variable_sums(msg, layout)
        v2c = belief.index_select(-1, gather).reshape(msg.shape) - msg
        neg = (v2c < 0) & mask
        odd = (neg.sum(-1, keepdim=True, dtype=SYMBOL_DTYPE) + neg) % 2 == 1
        mag = torch.where(mask, torch.abs(v2c), torch.inf)
        m1 = torch.amin(mag, dim=-1, keepdim=True)
        is_min = mag == m1
        n_min = is_min.sum(-1, keepdim=True, dtype=SYMBOL_DTYPE)
        m2 = torch.amin(torch.where(is_min, torch.inf, mag), dim=-1, keepdim=True)
        m2 = torch.where(n_min > 1, m1, m2)
        new = torch.where(odd, -coef, coef) * torch.where(is_min & (n_min == 1), m2, m1)
        msg = torch.where(mask & torch.isfinite(new), new, 0.0)
    return llr + variable_sums(msg, layout)


class LdpcCode(NamedTuple):
    """The reference's ``(h, g, k, data_cols)`` on a device, with the
    decoder's layout."""
    h: torch.Tensor          # (m, n) int32
    g: torch.Tensor          # (k, n) int32
    k: int
    data_cols: torch.Tensor  # (k,) int64
    layout: Tanner


def ldpc_code(h_g=None, device=None) -> LdpcCode:
    """An `LdpcCode` from a ``make_regular_ldpc`` tuple (default: its
    (96, 3, 6) code) on `device`. The layout is the reference's: each
    check's columns in order, padded with column 0 up to the largest row
    degree, every slot an edge."""
    h, g, k, data_cols = make_regular_ldpc() if h_g is None else h_g
    h = np.asarray(h)
    m, n = h.shape
    dc = int(h.sum(1).max())
    edge_col = np.zeros((m, dc), np.int32)
    for r in range(m):
        cs = np.nonzero(h[r])[0]
        edge_col[r, : len(cs)] = cs
    as_int = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    return LdpcCode(as_int(h), as_int(g), int(k),
                    torch.from_numpy(np.asarray(data_cols, np.int64)).to(device),
                    tanner(edge_col, np.ones((m, dc), bool), n, device))


def _code(h_g, device) -> LdpcCode:
    return h_g if isinstance(h_g, LdpcCode) else ldpc_code(h_g, device)


def ldpc_encode(bits, h_g=None) -> torch.Tensor:
    """(..., k) -> (..., n) int32 codewords c = u·G mod 2, an int32 sum."""
    u = to_tensor(bits, SYMBOL_DTYPE)
    code = _code(h_g, u.device)
    return (u[..., :, None] * code.g).sum(-2, dtype=SYMBOL_DTYPE) % 2


def ldpc_decode(llr, h_g=None, iters: int = 25, alpha: float = 0.8):
    """Normalised min-sum decode of channel LLRs (..., n) (positive = bit 0).

    Returns hard bits (..., n) int32 and a parity-satisfied flag (...,).
    `h_g` is a ``make_regular_ldpc`` tuple or an `LdpcCode` (default: the
    (96, 3, 6) code)."""
    llr = to_tensor(llr, REAL_DTYPE)
    code = _code(h_g, llr.device)
    belief = min_sum(llr, code.layout, iters, alpha)
    hard = (belief < 0).to(SYMBOL_DTYPE)
    parity = (hard[..., None, :] * code.h).sum(-1, dtype=SYMBOL_DTYPE) % 2
    return hard, torch.all(parity == 0, dim=-1)


def ldpc_extract_data(hard_bits, h_g=None) -> torch.Tensor:
    """The k information bits: u[i] = c[data_cols[i]]."""
    hard = to_tensor(hard_bits)
    return hard.index_select(-1, _code(h_g, hard.device).data_cols)
