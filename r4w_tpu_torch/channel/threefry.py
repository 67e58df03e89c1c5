"""The reference's Gaussian noise, drawn in numpy.

The JAX package draws its AWGN from ``jax.random`` (threefry2x32 with
partitionable counters, JAX's default): a key from a seed, one split into
the real and imaginary parts' keys, uniform floats from the random bits,
and normals as √2·erfinv(u). This module re-implements those steps in
numpy, so that the port can put the reference's own noise for a seed
through a channel without importing JAX. The random bits equal JAX's bit
for bit; the normals agree within 3e-7 relative (about 1% of them differ
by a float32 ulp or two, from the rounding of log1p and of erfinv's
polynomial). `uniform` is ``jax.random.uniform`` in float32, `randint`
``jax.random.randint`` in int32 and `bernoulli` ``jax.random.bernoulli``,
each bit for bit.
Everything runs on the host; callers move the draws to their device.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# erfinv(x) for float32 (M. Giles' single-precision approximation, as XLA
# expands it): a degree-8 polynomial in w = -log1p(-x²) - 2.5 for w < 5,
# else in √w - 3, times x
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under `key`."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` for a 32-bit seed: (0, seed)."""
    return 0, int(seed) & 0xFFFFFFFF


def split(k: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split``: key i is threefry of the counter (0, i)."""
    y0, y1 = threefry2x32(k, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def random_bits(k: tuple[int, int], n: int) -> np.ndarray:
    """n 32-bit words: threefry of the 64-bit flat index (high word, low
    word), the two output words XORed."""
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(k, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return y0 ^ y1


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 erfinv by the polynomial XLA uses; ±inf at ±1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):  # ±1: w = inf, the result ±inf below
        w = (-np.log1p((-x * x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).astype(np.float32)
    for c_small, c_large in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, np.float32(c_small), np.float32(c_large)).astype(np.float64)
        # one rounding, as a fused multiply-add
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(np.float32)


def uniform(k: tuple[int, int], shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the top 23
    bits of each word OR'd into 1.0's exponent, minus 1, then scaled and
    offset in one rounding (XLA fuses them into a multiply-add; the float64
    product of two float32 values is exact) and raised to at least `minval`."""
    n = int(np.prod(shape, dtype=np.int64))
    bits = random_bits(k, n)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled).reshape(shape)


def normal(k: tuple[int, int], shape) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``: uniform u in (-1, 1) from
    the top 23 bits of each word, then √2·erfinv(u)."""
    n = int(np.prod(shape, dtype=np.int64))
    bits = random_bits(k, n)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.nextafter(np.float32(-1.0), np.float32(0.0)), np.float32(1.0)
    u = np.maximum(lo, (f * (hi - lo) + lo).astype(np.float32))
    return (np.float32(np.sqrt(2)) * erfinv(u)).reshape(shape)



def randint(k: tuple[int, int], shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval, int32)``: two words a
    value from the key's two halves (high, low), reduced modulo the span as
    (high mod span)·(2^32 mod span) + low mod span, in uint32."""
    n = int(np.prod(shape, dtype=np.int64))
    k_hi, k_lo = split(k, 2)
    hi, lo = random_bits(k_hi, n), random_bits(k_lo, n)
    span = np.uint32(max(maxval - minval, 1) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        mult = np.uint32((1 << 16) % int(span))
        mult = np.uint32((mult * mult) % span)
        offset = ((hi % span) * mult + lo % span) % span
    return (np.int32(minval) + offset.astype(np.int32)).reshape(shape)


def bernoulli(k: tuple[int, int], p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)``: a float32 uniform below p."""
    return uniform(k, shape) < np.float32(p)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(k, data)`` for 32-bit data: threefry of the
    counter (0, data)."""
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32), np.asarray([int(data) & 0xFFFFFFFF],
                                                                 np.uint32))
    return int(y0[0]), int(y1[0])


# The same draws as tensors on any device: the words are uint32 values held in
# int64 and masked to 32 bits after every add and shift, so the bits equal the
# numpy version's on every device. Nothing here reads a tensor on the host.
_MASK = 0xFFFFFFFF


def _rotl_tensor(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32_tensor(key, x0: torch.Tensor, x1: torch.Tensor):
    """`threefry2x32` on int64 tensors holding uint32 words. `key` is a pair
    of ints, or a pair of int64 tensors that broadcast against `x0` (a key
    an element)."""
    k0, k1 = (k & _MASK if isinstance(k, torch.Tensor) else int(k) & _MASK for k in key)
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl_tensor(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
    return x0, x1


def random_bits_tensor(k: tuple[int, int], n: int, device) -> torch.Tensor:
    """`random_bits` as an int64 tensor of uint32 words on `device`."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32_tensor(k, idx >> 32, idx & _MASK)
    return y0 ^ y1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 23 bits of each word, as `uniform`."""
    as_int32 = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return as_int32.view(torch.float32) - 1.0


def erfinv_tensor(x: torch.Tensor) -> torch.Tensor:
    """`erfinv` on a float32 tensor: the same roundings (log1p and the
    polynomial's fused steps in float64, rounded once each; the square root
    in float64, so it is correctly rounded on every device)."""
    w = (-torch.log1p((-x * x).double())).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).to(torch.float32)
    for c_small, c_large in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, float(np.float32(c_small)), float(np.float32(c_large)))
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def _normals(bits: torch.Tensor) -> torch.Tensor:
    """Standard normals from random words, as `normal` makes them."""
    f = _unit_floats(bits)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    span = float(np.float32(1.0) - np.float32(lo))
    u = torch.clamp_min(f * span + lo, lo)
    return float(np.float32(np.sqrt(2))) * erfinv_tensor(u)


def normal_tensor(k: tuple[int, int], shape, device) -> torch.Tensor:
    """`normal` (``jax.random.normal(k, shape, float32)``) made on `device`:
    the bits equal the numpy version's; the normals too but where float64
    log1p of the device's library and the host's round to different
    float32 values (rare)."""
    n = int(np.prod(shape, dtype=np.int64))
    return _normals(random_bits_tensor(k, n, device)).reshape(tuple(shape))


def normal_segments(keys, lengths, device) -> torch.Tensor:
    """``normal_tensor(keys[j], (lengths[j],), device)`` for every j,
    concatenated, in one pass: an element's word depends only on its key and
    its index within its own draw (partitionable counters), so each segment
    takes its key's words at indices 0 .. length - 1."""
    counts = torch.tensor(lengths, dtype=torch.int64, device=device)
    k = torch.tensor([[int(a) & _MASK, int(b) & _MASK] for a, b in keys], dtype=torch.int64,
                     device=device)
    seg = torch.repeat_interleave(torch.arange(len(lengths), device=device), counts)
    idx = torch.arange(seg.numel(), dtype=torch.int64, device=device) - (
        torch.cumsum(counts, 0) - counts)[seg]
    y0, y1 = threefry2x32_tensor((k[seg, 0], k[seg, 1]), idx >> 32, idx & _MASK)
    return _normals(y0 ^ y1)
