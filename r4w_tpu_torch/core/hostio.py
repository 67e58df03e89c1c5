"""The unit phasor, and the reference's compiled float32 arithmetic.

PyTorch counterpart of ``r4w_tpu.core.hostio.cis``. The rest of that
module works around complex transfers and complex constants that some TPU
runtimes lack; PyTorch has both (``.to(device)``,
``torch.zeros(..., dtype=torch.complex64)``), so nothing else is ported.
`complex_abs` is |z| by the formula of the reference's compiled `abs`
(`magnitude` takes it for complex samples and |x| for real ones),
which torch's `abs` (√(re² + im²) or hypot) misses by an ulp in about a
third of the values. `rounded_sum` is a sum rounded once to float32, the
rounding of the multiply-adds that the reference's compiled loops fuse;
`fma` is one such multiply-add, and `linspace` is ``jnp.linspace`` as the
reference's compiled form computes it with one.

Importing the module runs torch's CPU cos, sin, exp and log once on a few
samples (`_initialise_vector_math`): their vectorised library initialises
itself on its first call, and a first call long enough to be split across
threads (more than 2048 floats) could read it half initialised in the
second thread and return that half off by up to 1.5e-4 (measured: about
one fresh process in a hundred, on the first call only; a first call on
one thread never).
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, real_scalar, to_tensor


def cis(phase) -> torch.Tensor:
    """exp(j·phase) as complex64: complex(cos(phase), sin(phase)) of the
    float32 phase, as the reference builds it."""
    p = to_tensor(phase, REAL_DTYPE)
    return torch.complex(torch.cos(p), torch.sin(p))


def complex_abs(z) -> torch.Tensor:
    """|z| of complex64 as the reference's compiled `abs` computes it:
    hi·√(1 + (lo/hi)²), hi = max(|re|, |im|), lo = min(|re|, |im|), with
    1 + r² rounded once (a fused multiply-add there; through float64
    here, where r² is exact). Only correctly rounded operations, so the
    card's result is the CPU's: the square root is taken in float64 and
    rounded, since torch's float32 `sqrt` on the CPU is not correctly
    rounded."""
    z = to_tensor(z)
    a, b = torch.abs(z.real), torch.abs(z.imag)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    r = torch.where(hi > 0, lo / torch.where(hi > 0, hi, 1.0), 0.0).double()
    one_plus = (r * r + 1.0).to(REAL_DTYPE)
    return hi * torch.sqrt(one_plus.double()).to(REAL_DTYPE)


def magnitude(x) -> torch.Tensor:
    """|x| as float32: `complex_abs` for complex64, the plain |x| for real
    samples (the reference's ``jnp.abs(x).astype(float32)``)."""
    x = to_tensor(x)
    return complex_abs(x) if x.is_complex() else torch.abs(x).to(REAL_DTYPE)


def rounded_sum(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """a + b computed in float64 (either may be float32) and rounded once to
    float32, in one kernel (into `out` if given, which must alias neither).
    With `a` an exact float64 product of two float32 values, this is the
    rounding of a fused multiply-add (but for ties of the double rounding,
    about one in 2^29)."""
    if out is None:
        out = torch.empty(torch.broadcast_shapes(a.shape, b.shape), dtype=REAL_DTYPE,
                          device=a.device)
    return torch.add(a, b, out=out)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c of float32 tensors rounded once to float32 (a fused
    multiply-add), exactly: the product is exact in float64, the sum's
    float64 rounding error is kept (TwoSum), and where the float64 sum sits
    on a float32 midpoint that error decides the direction, so no double
    rounding remains."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.to(REAL_DTYPE)
    d = s - r.double()
    toward = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf).to(REAL_DTYPE))
    midpoint = (d != 0) & (2.0 * d == toward.double() - r.double())
    # on a midpoint the exact value lies past it toward `toward` when the
    # error points the same way as d, else on r's side
    return torch.where(midpoint & (err != 0) & ((err > 0) == (d > 0)), toward, r)


def linspace(start: float, stop, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as the reference's
    compiled form computes start·(1 − s) + stop·s: s = i·c with c the
    float32 1/(num − 1), stop·s reassociated to i·(stop·c) and fused into
    one multiply-add with start·(1 − s) (`fma`); then stop itself. `stop`
    may be a 0-dim tensor (the result follows its device) or a number (on
    `device`). The plain formula misses about a third of the points by an
    ulp."""
    stop_t = stop.to(REAL_DTYPE) if isinstance(stop, torch.Tensor) else real_scalar(stop, device)
    device = stop_t.device
    if num < 2:
        return torch.full((num,), start, dtype=REAL_DTYPE, device=device)
    div = num - 1
    c = real_scalar(1.0, device) / real_scalar(div, device)
    i = torch.arange(div, dtype=REAL_DTYPE, device=device)
    head = fma(i, stop_t * c, real_scalar(start, device) * (1 - i * c))
    return torch.cat([head, stop_t.reshape(1)])


def _initialise_vector_math() -> None:
    """One call each of torch's CPU cos, sin, exp and log on a single
    thread, before any call long enough to run on several."""
    probe = torch.zeros(8, dtype=REAL_DTYPE)
    for fn in (torch.cos, torch.sin, torch.exp, torch.log):
        fn(probe)


_initialise_vector_math()
