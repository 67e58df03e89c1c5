"""Fountain codes and rate matching on tensors.

PyTorch counterpart of ``r4w_tpu.fec.fountain``. `robust_soliton`,
`lt_generator` and `lt_decode` (Gaussian elimination over GF(2) with
data-dependent pivots) are numpy on the host, copied from the reference,
and so is `raptor_encode`'s parity precode. LT encoding is one GF(2)
product, an int32 masked sum (never a float product), for any number of
output symbols at once. Rate matching is a gather; de-matching sums the
repeats of each position in the order they arrive, one pass a repeat,
so float32 sums do not depend on a scatter's order.
"""

from __future__ import annotations

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, SYMBOL_DTYPE, to_tensor


def robust_soliton(k: int, c: float = 0.1, delta: float = 0.5
                   ) -> np.ndarray:
    """Robust soliton degree distribution (fountain_code.rs design)."""
    rho = np.zeros(k + 1)
    rho[1] = 1.0 / k
    d = np.arange(2, k + 1)
    rho[2:] = 1.0 / (d * (d - 1))
    r = c * np.log(k / delta) * np.sqrt(k)
    tau = np.zeros(k + 1)
    kr = int(round(k / r)) if r > 0 else k
    kr = max(1, min(kr, k))
    for i in range(1, kr):
        tau[i] = r / (i * k)
    tau[kr] = r * np.log(r / delta) / k if r > delta else 0.0
    p = rho + tau
    return p / p.sum()


def lt_generator(k: int, n: int, seed: int = 0,
                 dist: np.ndarray | None = None) -> np.ndarray:
    """Pseudorandom LT generator matrix (n, k) over GF(2); row i is the
    neighbor set of encoded symbol i (deterministic from seed, so the
    receiver rebuilds it from the same seed — the 'ESI' role)."""
    rng = np.random.default_rng(seed)
    p = dist if dist is not None else robust_soliton(k)
    degrees = rng.choice(np.arange(len(p)), size=n, p=p)
    g = np.zeros((n, k), np.uint8)
    for i, deg in enumerate(degrees):
        deg = max(1, min(int(deg), k))
        g[i, rng.choice(k, size=deg, replace=False)] = 1
    return g


def lt_encode(data_symbols, n: int, seed: int = 0) -> torch.Tensor:
    """Encode k source symbols into n LT symbols: one GF(2) product.
    data_symbols (k, ...) bit arrays -> (n, ...) int32."""
    x = to_tensor(data_symbols, SYMBOL_DTYPE)
    g = torch.from_numpy(lt_generator(x.shape[0], n, seed).astype(np.int32)).to(x.device)
    flat = x.reshape(x.shape[0], -1)
    out = (g[:, :, None] * flat[None]).sum(1, dtype=SYMBOL_DTYPE) % 2
    return out.reshape(n, *x.shape[1:])


def lt_decode(received, generator, k: int):
    """Gaussian elimination LT decode. received (m, ...) symbols with
    their generator rows (m, k) from lt_generator (the receiver rebuilds
    them from the shared seed). Returns (data (k, ...), ok)."""
    y = np.asarray(received).astype(np.uint8).copy()
    g = np.asarray(generator, np.uint8).copy()
    m = g.shape[0]
    extra = y.shape[1:]
    y = y.reshape(m, -1)
    col = 0
    piv_rows = []
    for col in range(k):
        piv = None
        for r in range(len(piv_rows), m):
            if g[r, col]:
                piv = r
                break
        if piv is None:
            return np.zeros((k, *extra), np.uint8), False
        r0 = len(piv_rows)
        g[[r0, piv]] = g[[piv, r0]]
        y[[r0, piv]] = y[[piv, r0]]
        for r in range(m):
            if r != r0 and g[r, col]:
                g[r] ^= g[r0]
                y[r] ^= y[r0]
        piv_rows.append(r0)
    data = y[:k].reshape(k, *extra)
    return data, True


def raptor_encode(data_symbols, n: int, seed: int = 0, precode_overhead: int = 4):
    """Systematic raptor-style encode: a simple parity precode adds
    `precode_overhead` XOR parities (on the host, the reference's draws),
    then LT-encodes the intermediate block on the data's device. Returns
    (encoded (n, ...), k_intermediate)."""
    device = data_symbols.device if isinstance(data_symbols, torch.Tensor) else None
    if isinstance(data_symbols, torch.Tensor):
        data_symbols = data_symbols.cpu().numpy()
    x = np.asarray(data_symbols).astype(np.uint8)
    k = x.shape[0]
    rng = np.random.default_rng(seed + 7)
    parities = []
    for _ in range(precode_overhead):
        sel = rng.choice(k, size=max(2, k // 2), replace=False)
        parities.append(np.bitwise_xor.reduce(x[sel], axis=0) % 2)
    inter = np.concatenate([x, np.stack(parities)], axis=0)
    return lt_encode(to_tensor(inter, device=device), n, seed), inter.shape[0]


# ----------------------------------------------------------- rate match


def _match_indices(n: int, target_len: int, device) -> torch.Tensor:
    """Positions read by `rate_match`: evenly spread when puncturing, a
    wrap around when repeating."""
    t = torch.arange(target_len, device=device)
    return (t * n // max(target_len, 1)) % n if target_len < n else t % n


def rate_match(bits, target_len: int):
    """Circular-buffer rate matching: puncture (drop evenly) or repeat
    (wrap around) to exactly target_len bits. Returns (bits (..., target_len),
    the kept positions as numpy when puncturing, else None)."""
    b = to_tensor(bits)
    n = b.shape[-1]
    idx = _match_indices(n, target_len, b.device)
    return b.index_select(-1, idx), idx.cpu().numpy() if target_len < n else None


def rate_dematch(bits, original_len: int, combine: str = "llr") -> torch.Tensor:
    """Invert `rate_match`: add the repeats of each position (soft combining),
    or put zeros (erasures) at punctured positions. float32."""
    b = to_tensor(bits, REAL_DTYPE)
    t = b.shape[-1]
    n = original_len
    out = torch.zeros((*b.shape[:-1], n), dtype=REAL_DTYPE, device=b.device)
    if t >= n:
        for start in range(0, t, n):  # repeat r covers positions 0 .. its length
            part = b[..., start: start + n]
            out[..., : part.shape[-1]] += part
        return out
    return out.index_copy(-1, _match_indices(n, t, b.device), b)
