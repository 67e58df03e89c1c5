"""Convolutional coding: encoder, Viterbi decoder, puncturing.

PyTorch counterpart of ``r4w_tpu.fec.convolutional``. Polynomials are
integers over the constraint length K, e.g. the K=7 (0o171, 0o133) pair.
Convention: state = previous K-1 input bits, newest bit is the MSB fed
into the register; generator bit i of output = parity(poly & register).

The decoder computes per-codeword branch metrics (T, C, L) with lanes
last, runs the forward add-compare-select and the survivor traceback
through `kernels.viterbi` (the Hopper kernels on a CUDA tensor, their
plain PyTorch versions on a CPU tensor), and slices off the flush bits.
Branch metrics are FP32 elementwise products summed in generator order,
never a matmul: with ±1 expected values the products and, at R = 2, the
single add are exact, so the metrics equal the reference's bit for bit; at
R = 3 the two adds round as the reference's einsum does (the K = 7 rate-1/3
code's metrics and decodes are held against it bit for bit).
`map_decode` is the max-log-MAP (BCJR) soft-output decoder: its forward
and backward recursions are step loops over time, each step vectorised
over the states through predecessor tables, and the LLRs of all steps
are computed at once; float32 adds and maxes in the reference's order, so
the LLRs equal the reference's.
Functions follow the device of a tensor input; other inputs (numpy
arrays, lists) are put on the CUDA card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, SYMBOL_DTYPE, to_tensor
from r4w_tpu_torch.kernels import viterbi as viterbi_kernels

K7_POLYS = (0o171, 0o133)


@functools.lru_cache(maxsize=None)
def _trellis(constraint: int, polys: tuple[int, ...]):
    """Trellis tables: (outputs[S, 2, R] bit outputs int8, next_state[S, 2]
    int32), S = 2^(K-1) states and input bit b in {0, 1}."""
    k = constraint
    s = 1 << (k - 1)
    r = len(polys)
    outputs = np.zeros((s, 2, r), np.int8)
    next_state = np.zeros((s, 2), np.int32)
    for st in range(s):
        for b in (0, 1):
            reg = (b << (k - 1)) | st  # newest bit on top of state bits
            for gi, p in enumerate(polys):
                outputs[st, b, gi] = bin(reg & p).count("1") & 1
            next_state[st, b] = reg >> 1
    return outputs, next_state


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of each non-negative int32 value, by XOR folds."""
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    return (x ^ (x >> 1)) & 1


def conv_encode(bits, constraint: int = 7, polys: tuple[int, ...] = K7_POLYS,
                terminate: bool = True) -> torch.Tensor:
    """Encode bits (..., N) -> coded bits (..., N'·R), rate 1/len(polys).

    With terminate=True, K-1 zero flush bits are appended so the decoder
    ends in state 0. The register value at step n is
    Σ_j bit[n - j] << (K-1-j); each output is the parity of the register
    under its generator, by XOR folds (CUDA has no integer matmul).
    """
    bits = to_tensor(bits, SYMBOL_DTYPE)
    k = constraint
    if terminate:
        bits = torch.nn.functional.pad(bits, (0, k - 1))
    n = bits.shape[-1]
    padded = torch.nn.functional.pad(bits, (k - 1, 0))
    reg = torch.zeros_like(bits)
    for j in range(k):  # bit n-j sits at register bit K-1-j
        reg = reg | (padded[..., k - 1 - j: k - 1 - j + n] << (k - 1 - j))
    par = torch.stack([_parity(reg & p) for p in polys], dim=-1)  # (..., N, R)
    return par.reshape(*par.shape[:-2], -1)


@functools.lru_cache(maxsize=None)
def _expected_codes(r: int, device: torch.device) -> torch.Tensor:
    """(C, R) ±1 values of each codeword, generator r at bit r."""
    code_bits = (np.arange(1 << r)[:, None] >> np.arange(r)[None, :]) & 1
    return torch.from_numpy((1.0 - 2.0 * code_bits).astype(np.float32)).to(device)


def _branch_metrics(rx: torch.Tensor) -> torch.Tensor:
    """rx (L, T, R) ±1-convention values -> bm (T, C, L) float32:
    bm[t, c, l] = Σ_r rx[l, t, r]·expected[c, r], summed in r order."""
    r = rx.shape[-1]
    expected = _expected_codes(r, rx.device)
    rx_t = rx.permute(1, 2, 0)  # (T, R, L)
    bm = rx_t[:, 0, None, :] * expected[:, 0, None]
    for i in range(1, r):
        bm = bm + rx_t[:, i, None, :] * expected[:, i, None]
    return bm.contiguous()


def viterbi_decode(received, constraint: int = 7, polys: tuple[int, ...] = K7_POLYS,
                   terminated: bool = True, soft: bool = False) -> torch.Tensor:
    """Viterbi decode (..., N·R) -> decoded bits (..., N_info) int32.

    received: hard bits, or with soft=True values in about [-1, 1] per
    coded bit with the convention value = 1 - 2·bit (+1 means bit 0).
    Leading axes are lanes of one batched decode. terminated=True starts
    the traceback from state 0 and removes the K-1 flush bits;
    terminated=False starts it from the best final metric (the first, on
    ties) and keeps every bit.
    """
    polys = tuple(polys)
    r = len(polys)
    rx = to_tensor(received, REAL_DTYPE)
    lead = rx.shape[:-1]
    n_steps = rx.shape[-1] // r
    rx = rx[..., : n_steps * r].reshape(lead.numel(), n_steps, r)
    if not soft:
        rx = 1.0 - 2.0 * rx  # bits -> ±1
    bm = _branch_metrics(rx)
    dec, final = viterbi_kernels.viterbi_forward_dispatch(bm, constraint, polys)
    start = None if terminated else torch.argmax(final, dim=0).to(SYMBOL_DTYPE)
    bits = viterbi_kernels.viterbi_traceback_dispatch(dec, constraint, polys, start).T
    if terminated:
        bits = bits[:, : n_steps - (constraint - 1)]
    return bits.reshape(*lead, bits.shape[-1])


def viterbi_decode_mxu(received, constraint: int = 7, polys: tuple[int, ...] = K7_POLYS,
                       soft: bool = False) -> torch.Tensor:
    """Terminated Viterbi decode, the counterpart of the reference's Pallas
    decoder of this name: `viterbi_decode(terminated=True)`, which on a CUDA
    tensor already runs both Hopper kernels. No lane or time padding: the
    kernels mask the ragged lane block and loop over exactly T steps."""
    return viterbi_decode(received, constraint, polys, terminated=True, soft=soft)


def puncture(coded, pattern) -> torch.Tensor:
    """Remove bits where pattern == 0, cycling the pattern."""
    coded = to_tensor(coded)
    mask = np.resize(np.asarray(pattern).astype(bool), coded.shape[-1])
    keep = torch.from_numpy(np.nonzero(mask)[0]).to(coded.device)
    return coded.index_select(-1, keep)


def depuncture(punctured, pattern, total_len: int, fill=0.0) -> torch.Tensor:
    """Reinsert `fill` at punctured positions: (..., n_kept) -> (..., total_len) float32."""
    punctured = to_tensor(punctured, REAL_DTYPE)
    mask = np.resize(np.asarray(pattern).astype(bool), total_len)
    keep = torch.from_numpy(np.nonzero(mask)[0]).to(punctured.device)
    out = torch.full((*punctured.shape[:-1], total_len), fill, dtype=REAL_DTYPE,
                     device=punctured.device)
    return out.index_copy(-1, keep, punctured)


def map_decode(received, constraint: int = 7, polys: tuple[int, ...] = K7_POLYS,
               terminated: bool = True):
    """Max-log-MAP (BCJR) soft-output decode -> (LLRs (..., N_info) float32,
    LLR > 0 meaning bit 0, and hard decisions (..., N_info) int32).

    received: soft values in ±1 per coded bit (+1 ~ bit 0), as
    `viterbi_decode(soft=True)` takes them; leading axes are frames.
    terminated=True starts β in state 0 and drops the K-1 flush bits;
    terminated=False starts β uniform and keeps every bit.
    """
    polys = tuple(polys)
    r = len(polys)
    s = 1 << (constraint - 1)
    rx = to_tensor(received, REAL_DTYPE)
    lead = rx.shape[:-1]
    n_steps = rx.shape[-1] // r
    rx = rx[..., : n_steps * r].reshape(lead.numel(), n_steps, r)
    code = viterbi_kernels._code_index_t(constraint, polys, rx.device)  # (S, 2)
    # bm[t, l, st, b] = metric of the codeword leaving st on input b
    bm = _branch_metrics(rx).permute(0, 2, 1).index_select(-1, code.reshape(-1))
    bm = bm.reshape(n_steps, rx.shape[0], s, 2)
    _, next_np = _trellis(constraint, polys)
    nxt = torch.from_numpy(next_np.reshape(-1).astype(np.int64)).to(rx.device)
    # the two (st, b) into target s' = b·S/2 + m are (2m, b) and (2m+1, b)
    target = torch.arange(s, device=rx.device)
    into_state = torch.stack([2 * (target % (s // 2)), 2 * (target % (s // 2)) + 1], dim=-1)
    into_bit = (target // (s // 2))[:, None].expand(s, 2)
    into = (into_state * 2 + into_bit).reshape(-1)
    bm_into = bm.reshape(n_steps, -1, 2 * s).index_select(-1, into).reshape(bm.shape)

    floor = viterbi_kernels.UNREACHED  # the start metric of every state but 0
    alpha = torch.full(bm.shape[1:-1], floor, dtype=REAL_DTYPE, device=rx.device)
    alpha[:, 0] = 0.0
    alphas = []
    for t in range(n_steps):
        alphas.append(alpha)
        cand = alpha.index_select(-1, into_state.reshape(-1)).reshape(bm.shape[1:]) + bm_into[t]
        new = torch.clamp_min(torch.amax(cand, dim=-1), floor)
        alpha = new - torch.amax(new, dim=-1, keepdim=True)

    beta = torch.full_like(alpha, floor) if terminated else torch.zeros_like(alpha)
    if terminated:
        beta[:, 0] = 0.0
    betas = [beta]
    for t in range(n_steps - 1, 0, -1):
        new = torch.amax(bm[t] + beta.index_select(-1, nxt).reshape(bm.shape[1:]), dim=-1)
        beta = new - torch.amax(new, dim=-1, keepdim=True)
        betas.append(beta)
    alphas, betas = torch.stack(alphas), torch.stack(betas[::-1])  # betas[t] = β_{t+1}

    metric = (alphas[..., None] + bm) + betas.index_select(-1, nxt).reshape(bm.shape)
    llr = (torch.amax(metric[..., 0], dim=-1) - torch.amax(metric[..., 1], dim=-1)).T
    if terminated:
        llr = llr[:, : n_steps - (constraint - 1)]
    llr = llr.reshape(*lead, llr.shape[-1])
    return llr, (llr < 0).to(SYMBOL_DTYPE)
