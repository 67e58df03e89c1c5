"""Core types and dtype policy.

PyTorch counterpart of ``r4w_tpu.core.types``: IQ samples are
``complex64`` tensors (batch-first blocks), symbols are ``int32``
tensors, and errors are Python exceptions raised on the host before any
kernel runs. Complex tensors move between devices with ``.to(device)``;
nothing here splits them into real planes.

Entry points that create tensors put them on `DEFAULT_DEVICE`, the CUDA
card, unless the caller names another device; functions that take a
tensor follow that tensor's device.
"""

from __future__ import annotations

import dataclasses

import torch

# Dtype policy ---------------------------------------------------------------
IQ_DTYPE = torch.complex64
REAL_DTYPE = torch.float32
SYMBOL_DTYPE = torch.int32

# Device policy --------------------------------------------------------------
DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `DEFAULT_DEVICE`.

    There is no fallback to the CPU: on a machine without a card, a
    caller that wants the CPU says so.
    """
    return DEFAULT_DEVICE if device is None else torch.device(device)


def to_tensor(x, dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """`x` as a tensor of `dtype` (default: keep or infer it).

    A tensor stays on its own device unless `device` is named; anything
    else (numpy arrays, lists, scalars) is created on
    `resolve_device(device)`.
    """
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def real_scalar(value: float, device) -> torch.Tensor:
    """`value` as a 0-dim float32 tensor filled on `device`.

    Use it as a divisor where the result must be the float32 quotient that
    the reference computes: in torch a Python number over a tensor is the
    tensor's reciprocal times the number, and a CUDA tensor over a Python
    number is the tensor times the number's reciprocal, each an ulp off in
    some elements; a tensor over a tensor divides on every device. Filling
    on the device avoids a copy from host memory, which waits for the
    stream.
    """
    return torch.full((), value, dtype=REAL_DTYPE, device=device)


class DspError(Exception):
    """Base error for DSP parameter/shape problems."""


class InvalidParameter(DspError):
    pass


class BufferTooShort(DspError):
    def __init__(self, expected: int, actual: int):
        super().__init__(f"buffer too short: expected {expected}, got {actual}")
        self.expected = expected
        self.actual = actual


@dataclasses.dataclass(frozen=True)
class CommonParams:
    """Common waveform parameters."""

    sample_rate: float = 125_000.0
    carrier_freq: float = 0.0
    amplitude: float = 1.0


def db_to_linear_power(db, device=None) -> torch.Tensor:
    return 10.0 ** (to_tensor(db, REAL_DTYPE, device) / 10.0)


def db_to_linear_amplitude(db, device=None) -> torch.Tensor:
    return 10.0 ** (to_tensor(db, REAL_DTYPE, device) / 20.0)


def linear_power_to_db(p, device=None) -> torch.Tensor:
    return 10.0 * torch.log10(to_tensor(p, REAL_DTYPE, device))


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()
