"""The unit phasor, and the reference's compiled float32 arithmetic.

PyTorch counterpart of ``r4w_tpu.core.hostio.cis``. The rest of that
module works around complex transfers and complex constants that some TPU
runtimes lack; PyTorch has both (``.to(device)``,
``torch.zeros(..., dtype=torch.complex64)``), so nothing else is ported.
`complex_abs` is |z| by the formula of the reference's compiled `abs`,
which torch's `abs` (√(re² + im²) or hypot) misses by an ulp in about a
third of the values. `rounded_sum` is a sum rounded once to float32, the
rounding of the multiply-adds that the reference's compiled loops fuse.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, to_tensor


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
