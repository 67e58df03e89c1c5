"""Turbo code on tensors: parallel-concatenated RSC(1, 5/7) and an
iterative max-log-MAP decoder.

PyTorch counterpart of ``r4w_tpu.fec.turbo``. `_rsc_tables`, `rsc_encode`
and `default_interleaver` are numpy and copied from the reference. The
encoder runs the recursive code's parity as GF(2) prefix sums (its
feedback 1 + D + D² has the period-3 impulse response 1, 1, 0), with no
step loop. `_bcjr_maxlog` keeps the reference's name (the equalisers call
it): its forward and backward recursions are step loops over time whose
step is vectorised over the four states through predecessor tables (a
gather, an add, a max, the -1e9 floor and the renormalisation), and the
per-bit LLRs are computed for every step at once. Every operation is a
float32 add, subtract or max in the reference's order, so the LLRs equal
the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, SYMBOL_DTYPE, to_tensor

# RSC generator (1, g2/g1) with g1 = 7 (feedback), g2 = 5, K=3, 4 states
_K = 3
_S = 4


@functools.lru_cache(maxsize=None)
def _rsc_tables():
    """next_state[s, u], parity[s, u] for RSC with feedback 7, forward 5."""
    nxt = np.zeros((_S, 2), np.int32)
    par = np.zeros((_S, 2), np.int32)
    for s in range(_S):
        s1, s0 = (s >> 1) & 1, s & 1
        for u in (0, 1):
            # feedback bit: a = u ^ s1 ^ s0   (g1 = 1+D+D^2)
            a = u ^ s1 ^ s0
            # parity: p = a ^ s0  -> g2 = 1+D^2
            p = a ^ s0
            nxt[s, u] = ((a << 1) | s1)
            par[s, u] = p
    return nxt, par


def rsc_encode(bits: np.ndarray):
    """Systematic RSC encode; returns (parity_bits, final_state)."""
    nxt, par = _rsc_tables()
    s = 0
    out = np.zeros(len(bits), np.int32)
    for i, u in enumerate(np.asarray(bits, np.int32)):
        out[i] = par[s, u]
        s = nxt[s, u]
    return out, s


def default_interleaver(n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(n).astype(np.int32)


UNREACHED = -1e9


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=SYMBOL_DTYPE) % 2


def _rsc_parity(bits: torch.Tensor) -> torch.Tensor:
    """The RSC's parity bits (..., N) from state 0, without a step loop:
    the feedback bit a_t = u_t ⊕ a_{t-1} ⊕ a_{t-2} is the XOR of u_j over
    j <= t with t - j ≢ 2 (mod 3), and p_t = a_t ⊕ a_{t-2}."""
    n = bits.shape[-1]
    t = torch.arange(n, device=bits.device)
    # XOR of u_j over j <= t and j ≡ t + 1 (mod 3): one prefix XOR per residue class
    by_class = torch.stack([_prefix_xor(bits * (t % 3 == c)) for c in range(3)])
    skipped = by_class.gather(0, ((t + 1) % 3).expand(1, *bits.shape))[0]
    a = _prefix_xor(bits) ^ skipped
    return a ^ torch.nn.functional.pad(a, (2, 0))[..., :n]


def turbo_encode(bits, interleaver: np.ndarray | None = None):
    """bits (N,) -> (systematic, parity1, parity2, interleaver): rate 1/3,
    no termination tail. The three bit streams are int32 tensors on the
    bits' device; the interleaver is returned as given (default:
    `default_interleaver(N)`)."""
    bits = to_tensor(bits, SYMBOL_DTYPE)
    n = bits.shape[-1]
    pi = interleaver if interleaver is not None else default_interleaver(n)
    pi_t = torch.as_tensor(pi, dtype=torch.long, device=bits.device)
    return bits, _rsc_parity(bits), _rsc_parity(bits.index_select(-1, pi_t)), pi


@functools.lru_cache(maxsize=None)
def _bcjr_tables(device: torch.device):
    """Flat (state, input) indices, as tensors on `device`: `pred` (S·2,)
    of the two (s, u) reaching each s' (s' major), `nxt` (S·2,) of the
    next state of each (s, u), and the ±1 signs of u and of the parity
    (S, 2)."""
    nxt, par = _rsc_tables()
    pred = [[s * 2 + u for s in range(_S) for u in (0, 1) if nxt[s, u] == sp]
            for sp in range(_S)]
    as_long = lambda a: torch.as_tensor(np.asarray(a).reshape(-1), dtype=torch.long,
                                        device=device)
    sgn_u = torch.tensor([1.0, -1.0], dtype=REAL_DTYPE, device=device)
    sgn_p = torch.from_numpy(1.0 - 2.0 * par.astype(np.float32)).to(device)
    return as_long(pred), as_long(nxt), sgn_u, sgn_p


def _bcjr_maxlog(llr_sys, llr_par, llr_apriori) -> torch.Tensor:
    """Max-log-MAP for one RSC constituent.

    llr_* : (..., N) channel LLRs (positive = bit 0) and a-priori LLRs.
    Returns the extrinsic LLR (..., N): the posterior minus
    llr_sys + llr_apriori. The trellis starts in state 0 and ends
    unterminated (uniform β).
    """
    llr_sys = to_tensor(llr_sys, REAL_DTYPE)
    pred, nxt, sgn_u, sgn_p = _bcjr_tables(llr_sys.device)
    lsys = llr_sys + llr_apriori
    # γ(s, u) = 0.5·((1-2u)·(llr_sys + llr_apriori) + (1-2p(s,u))·llr_par), time first
    ls, lp = lsys.movedim(-1, 0), to_tensor(llr_par, REAL_DTYPE).movedim(-1, 0)
    gamma = 0.5 * (sgn_u * ls[..., None, None] + sgn_p * lp[..., None, None])  # (N, ..., S, 2)
    flat = gamma.reshape(*gamma.shape[:-2], 2 * _S)
    g_into = flat.index_select(-1, pred).reshape(gamma.shape)  # γ of the branches into s'
    steps = gamma.shape[0]

    alpha = torch.full(gamma.shape[1:-1], UNREACHED, dtype=REAL_DTYPE, device=lsys.device)
    alpha[..., 0] = 0.0
    alphas = []
    for t in range(steps):
        alphas.append(alpha)
        cand = alpha.index_select(-1, pred // 2).reshape(g_into.shape[1:]) + g_into[t]
        new = torch.clamp_min(torch.amax(cand, dim=-1), UNREACHED)
        alpha = new - torch.amax(new, dim=-1, keepdim=True)

    beta = torch.zeros_like(alpha)  # unterminated: uniform
    betas = [beta]
    for t in range(steps - 1, 0, -1):
        cand = gamma[t] + beta.index_select(-1, nxt).reshape(gamma.shape[1:])
        new = torch.clamp_min(torch.amax(cand, dim=-1), UNREACHED)
        beta = new - torch.amax(new, dim=-1, keepdim=True)
        betas.append(beta)
    alphas, betas = torch.stack(alphas), torch.stack(betas[::-1])  # betas[t] = β_{t+1}

    total = ((alphas[..., :, None] + gamma)
             + betas.index_select(-1, nxt).reshape(gamma.shape))
    llr_post = torch.amax(total[..., 0], dim=-1) - torch.amax(total[..., 1], dim=-1)
    return llr_post.movedim(0, -1) - lsys


def turbo_decode(llr_sys, llr_p1, llr_p2, interleaver, iters: int = 6):
    """Iterative turbo decode of LLRs (..., N), positive = bit 0.

    Returns (hard bits (..., N) int32, posterior LLR (..., N))."""
    llr_sys = to_tensor(llr_sys, REAL_DTYPE)
    llr_p1 = to_tensor(llr_p1, REAL_DTYPE, llr_sys.device)
    llr_p2 = to_tensor(llr_p2, REAL_DTYPE, llr_sys.device)
    pi = torch.as_tensor(interleaver, dtype=torch.long, device=llr_sys.device)
    inv = torch.empty_like(pi)
    inv[pi] = torch.arange(pi.numel(), device=pi.device)
    sys_pi = llr_sys.index_select(-1, pi)
    apriori = torch.zeros_like(llr_sys)
    for _ in range(iters):
        ext1 = _bcjr_maxlog(llr_sys, llr_p1, apriori)
        ext2 = _bcjr_maxlog(sys_pi, llr_p2, ext1.index_select(-1, pi))
        apriori = ext2.index_select(-1, inv)
    post = llr_sys + apriori + ext1
    return (post < 0).to(SYMBOL_DTYPE), post
