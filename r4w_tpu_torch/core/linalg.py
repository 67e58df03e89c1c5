"""Small complex least squares.

PyTorch counterpart of ``r4w_tpu.core.linalg``. `complex_lstsq` solves the
ridge-regularised normal equations through the real 2x2 block embedding
[[Re M, -Im M], [Im M, Re M]] with ``torch.linalg.solve``, as the
reference does with ``jnp.linalg.solve``, so both packages compute the
same thing (a complex QR or SVD would be another algorithm). It is meant
for the catalog's small estimation systems (channel estimators, tens of
unknowns), where the normal equations' conditioning does not matter. The
products are float32 (complex64) and never TF32: the port does not enable
it. Leading batch axes of `a` and `b` are systems solved together.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, to_tensor


def complex_lstsq(a, b, ridge: float = 1e-9) -> torch.Tensor:
    """argmin_h ||a @ h - b||² for complex a (..., m, n), b (..., m).

    `ridge` scales with trace(aᴴa)/n, so the regularisation is relative to
    the problem's energy."""
    a = to_tensor(a, IQ_DTYPE)
    b = to_tensor(b, IQ_DTYPE, device=a.device)
    ah = a.conj().transpose(-2, -1)
    m = ah @ a                                     # (..., n, n) hermitian
    v = (ah @ b[..., None])[..., 0]                # (..., n)
    n = m.shape[-1]
    lam = ridge * torch.diagonal(m, dim1=-2, dim2=-1).real.sum(-1) / n
    m = m + lam[..., None, None] * torch.eye(n, dtype=m.dtype, device=m.device)
    mr, mi = m.real, m.imag
    block = torch.cat([torch.cat([mr, -mi], dim=-1), torch.cat([mi, mr], dim=-1)], dim=-2)
    rhs = torch.cat([v.real, v.imag], dim=-1)
    sol = torch.linalg.solve(block, rhs[..., None])[..., 0]
    return torch.complex(sol[..., :n], sol[..., n:])
