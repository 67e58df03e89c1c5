"""Convenience one-stop import surface (prelude.rs): ``from
r4w_tpu_torch.prelude import *`` brings the common entry points into scope,
the names of ``r4w_tpu.prelude`` pointing at the port. `to_device` and
`to_host` are plain moves here: a tensor (or array) to a device, a tensor
to a numpy array on the host."""

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, DspError, to_tensor  # noqa: F401
from r4w_tpu_torch.core import fftops  # noqa: F401
from r4w_tpu_torch.core.hostio import cis  # noqa: F401
from r4w_tpu_torch.waveforms import create_waveform, list_waveforms  # noqa: F401
from r4w_tpu_torch.channel import awgn  # noqa: F401
from r4w_tpu_torch.registry import default_registry  # noqa: F401
from r4w_tpu_torch.ops import filters, pulse, sync, measure  # noqa: F401


def to_device(x, device=None) -> torch.Tensor:
    """`x` as a tensor on `device` (the card unless named)."""
    return to_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device=device)


def to_host(x) -> np.ndarray:
    """`x` as a numpy array, a tensor read whole to the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


__all__ = [
    "IQ_DTYPE", "REAL_DTYPE", "DspError", "fftops", "cis",
    "to_device", "to_host", "create_waveform", "list_waveforms",
    "awgn", "default_registry", "filters", "pulse", "sync", "measure",
]
