"""Trellis-coded modulation on tensors: pragmatic 8PSK TCM.

PyTorch counterpart of ``r4w_tpu.fec.tcm``. Two information bits a
symbol: the low bit runs through the rate-1/2 K=3 (7, 5) convolutional
code, whose coded pair picks one of four phases through `_SUBSET_MAP`;
the high bit is uncoded and adds 180°:

    symbol index = 4·b_uncoded + m(c1, c0),   point = e^{jπ·idx/4}

`tcm_encode` computes every symbol at once: the K=3 register at step t
holds the coded bits t, t-1 and t-2, and each coded bit is an XOR of
them. `tcm_decode` takes, per symbol and coded pair, the nearer of the
pair's two antipodal points, and runs the 4-state Viterbi search on the
port's Viterbi kernels (`kernels.viterbi`, K = 3, polys (7, 5)): the
trellis is `fec.convolutional`'s (register (b << 2) | s, next state
register >> 1), the kernel maximises, so its branch metrics are the
negated squared distances, and both start at 0 in state 0 and -1e9 (the
reference's +1e9) elsewhere and take the even predecessor on a tie (the
reference's first). Negation is exact in float32, so the decisions are
the reference's. The uncoded bits are read off the surviving path
afterwards.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE, to_tensor
from r4w_tpu_torch.kernels import viterbi as viterbi_kernels

_K = 3
_POLYS = (0o7, 0o5)  # c1 = b+s1+s0, c0 = b+s0 (newest-first taps)
_N_STATES = 1 << (_K - 1)
# coded pair -> phase-subset index. Chosen by exhaustive search over
# the 24 assignments for maximum free distance: this one reaches
# d²free = 4.0 (= the parallel-transition bound) vs uncoded QPSK's
# 2.0 — the full 3 dB asymptotic set-partitioning gain. The natural
# assignment (0,1,2,3) only reaches ~1.17 and would LOSE to QPSK.
_SUBSET_MAP = np.asarray([3, 2, 0, 1], np.int32)


@functools.lru_cache(maxsize=None)
def _trellis():
    """next_state[s, b], coded_pair[s, b] for the K=3 (7,5) code."""
    nxt = np.zeros((_N_STATES, 2), np.int32)
    out = np.zeros((_N_STATES, 2), np.int32)
    for s in range(_N_STATES):
        for b in (0, 1):
            reg = (b << (_K - 1)) | s  # [newest b | s1 s0]
            c1 = bin(reg & _POLYS[0]).count("1") & 1
            c0 = bin(reg & _POLYS[1]).count("1") & 1
            out[s, b] = (c1 << 1) | c0
            nxt[s, b] = (reg >> 1) & (_N_STATES - 1)
    return nxt, out


# the kernels' codeword index (generator r at bit r: c1 at bit 0, c0 at
# bit 1) -> the coded pair (c1 << 1) | c0 that indexes `_SUBSET_MAP`
_PAIR_OF_CODEWORD = (0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _pair_of_codeword(device: torch.device) -> torch.Tensor:
    return torch.tensor(_PAIR_OF_CODEWORD, device=device)


@functools.lru_cache(maxsize=None)
def _points(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.exp(1j * np.pi * np.arange(8) / 4.0).astype(np.complex64)).to(device)


def _coded_pairs(coded: torch.Tensor) -> torch.Tensor:
    """The (c1 << 1) | c0 pair of each step of coded input bits (..., T),
    from state 0: c1 = b_t ⊕ b_{t-1} ⊕ b_{t-2}, c0 = b_t ⊕ b_{t-2}."""
    n = coded.shape[-1]
    prev1 = torch.nn.functional.pad(coded, (1, 0))[..., :n]
    prev2 = torch.nn.functional.pad(coded, (2, 0))[..., :n]
    return ((coded ^ prev1 ^ prev2) << 1) | (coded ^ prev2)


def tcm_encode(bits) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 2N) bits -> (symbol indices (..., N+2) int32, IQ points complex64).

    Bit pairs are (uncoded_high, coded_low) per symbol; two flush pairs
    terminate the trellis."""
    b = to_tensor(bits, SYMBOL_DTYPE)
    b = b.reshape(*b.shape[:-1], -1, 2)
    flush = (0, 2)  # two zero coded bits drive the state to 0
    coded = torch.nn.functional.pad(b[..., 1], flush)
    uncoded = torch.nn.functional.pad(b[..., 0], flush)
    subset = torch.from_numpy(_SUBSET_MAP.astype(np.int64)).to(b.device)
    idx = 4 * uncoded + subset[_coded_pairs(coded).long()].to(SYMBOL_DTYPE)
    return idx, _points(b.device)[idx.long()]


def tcm_branch_metrics(rx_symbols) -> tuple[torch.Tensor, torch.Tensor]:
    """Received symbols (..., T) -> (d_pair (..., T, 4) float32, the squared
    distance of each coded pair's nearer point; par_bit (..., T, 4) int32,
    1 where that point is the pair's uncoded-1 one)."""
    rx = to_tensor(rx_symbols, IQ_DTYPE)
    d2 = torch.abs(rx[..., None] - _points(rx.device)) ** 2  # (..., T, 8)
    smap = torch.from_numpy(_SUBSET_MAP.astype(np.int64)).to(rx.device)
    d_lo, d_hi = d2[..., smap], d2[..., smap + 4]
    return torch.minimum(d_lo, d_hi), (d_hi < d_lo).to(SYMBOL_DTYPE)


def viterbi_metrics(d_pair: torch.Tensor) -> torch.Tensor:
    """Pair metrics (L, T, 4) -> the Viterbi kernels' branch metrics (T, C, L):
    negated, each codeword at its pair."""
    bm = -d_pair.index_select(-1, _pair_of_codeword(d_pair.device))
    return bm.permute(1, 2, 0).contiguous()


def tcm_viterbi(d_pair: torch.Tensor) -> torch.Tensor:
    """The surviving path's coded bits (L, T) int32 of pair metrics (L, T, 4),
    through `viterbi_forward_dispatch` and `viterbi_traceback_dispatch`
    (the Hopper kernels on a CUDA tensor), the trellis ending in state 0."""
    dec, _ = viterbi_kernels.viterbi_forward_dispatch(viterbi_metrics(d_pair), _K, _POLYS)
    return viterbi_kernels.viterbi_traceback_dispatch(dec, _K, _POLYS).T


def tcm_decode(rx_symbols) -> torch.Tensor:
    """Received 8PSK-ish symbols (..., N+2) -> decoded bits (..., 2N) int32."""
    d_pair, par_bit = tcm_branch_metrics(rx_symbols)
    lead, steps = d_pair.shape[:-2], d_pair.shape[-2]
    coded = tcm_viterbi(d_pair.reshape(-1, steps, 4))
    pair = _coded_pairs(coded).long()
    unc = par_bit.reshape(-1, steps, 4).gather(-1, pair[..., None])[..., 0]
    n_info = steps - 2  # drop the flush pairs
    bits = torch.stack([unc[:, :n_info], coded[:, :n_info]], dim=-1)
    return bits.reshape(*lead, 2 * n_info)


def tcm_coding_gain_run(ebn0_db: float, n_bits: int = 40_000, seed: int = 0,
                        device=None) -> dict:
    """`tcm_coding_gain_demo`'s link with what it compares: the received
    symbols (``rx``, on `device`), TCM's decoded bits (``decisions``, numpy)
    and both BERs (``tcm_ber``, ``qpsk_ber``) at the same Es/N0 and 2
    bit/sym. The bits and both noises are the reference's draws from
    ``np.random.default_rng(seed)``; TCM runs on `device` (default: the
    card), the QPSK baseline on the host in numpy, as the reference's."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits).astype(np.int32)
    _, tx = tcm_encode(to_tensor(bits, device=device))
    es_n0 = 10.0 ** (ebn0_db / 10.0) * 2.0  # 2 bits/symbol
    sigma = np.sqrt(1.0 / (2.0 * es_n0))
    noise = (rng.standard_normal(tx.shape[-1])
             + 1j * rng.standard_normal(tx.shape[-1])) * sigma
    rx = tx + torch.from_numpy(noise.astype(np.complex64)).to(tx.device)
    dec = tcm_decode(rx).cpu().numpy()[:n_bits]
    tcm_ber = float(np.mean(dec != bits))

    # uncoded QPSK baseline, Gray mapping
    qb = bits.reshape(-1, 2)
    qsym = ((1 - 2.0 * qb[:, 0]) + 1j * (1 - 2.0 * qb[:, 1])) / np.sqrt(2)
    qn = (rng.standard_normal(len(qsym))
          + 1j * rng.standard_normal(len(qsym))) * sigma
    rxq = qsym + qn
    qdec = np.stack([(rxq.real < 0), (rxq.imag < 0)], axis=1).astype(int)
    q_ber = float(np.mean(qdec.reshape(-1) != bits))
    return {"rx": rx, "decisions": dec, "tcm_ber": tcm_ber, "qpsk_ber": q_ber}


def tcm_coding_gain_demo(ebn0_db: float, n_bits: int = 40_000, seed: int = 0,
                         device=None) -> tuple[float, float]:
    """(tcm_ber, uncoded_qpsk_ber) of `tcm_coding_gain_run`."""
    run = tcm_coding_gain_run(ebn0_db, n_bits, seed, device)
    return run["tcm_ber"], run["qpsk_ber"]
