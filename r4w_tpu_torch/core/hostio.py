"""The unit phasor.

PyTorch counterpart of ``r4w_tpu.core.hostio.cis``. The rest of that
module works around complex transfers and complex constants that some TPU
runtimes lack; PyTorch has both (``.to(device)``,
``torch.zeros(..., dtype=torch.complex64)``), so nothing else is ported.
"""

from __future__ import annotations

import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, to_tensor


def cis(phase) -> torch.Tensor:
    """exp(j·phase) as complex64: complex(cos(phase), sin(phase)) of the
    float32 phase, as the reference builds it."""
    p = to_tensor(phase, REAL_DTYPE)
    return torch.complex(torch.cos(p), torch.sin(p))
