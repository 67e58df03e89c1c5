"""Linear first-order recursion: plain PyTorch version and Hopper kernel.

``y[n] = u[n] + b·y[n-1]`` along the last axis, with y[-1] the carried
state (zeros when there is none) and b a real scalar; a complex row is two
real recursions, one a component. The one-pole filters compute their u
elementwise and call `first_order_recurrence_dispatch`: ``α·x`` with
b = 1 − α for `filters.single_pole_iir`, ``x[n] − x[n-1]`` with b = α for
`filters.dc_blocker`, x itself with b = α for `filters2.de_emphasis`.

The kernel, ``csrc/first_order_iir.cu``, has no Pallas counterpart: it
stands for the reference's ``lax.scan`` loops (``r4w_tpu/ops/filters.py``
:225 and :243, ``r4w_tpu/ops/filters2.py`` :454), which its compiler runs
as one loop on its device. The plain version is the step loop, two
launches a step (the product, then the sum, each rounded to float32); the
kernel rounds the same way (no fused multiply-add) and equals it bit for
bit. One warp walks a row, a lane a component, its input staged ahead of
the chain; the design is in the source's header.

`first_order_recurrence_dispatch` is what the filters call: the plain
version for a tensor on the CPU, the kernel for a tensor on a CUDA device,
and an error for anything else. It never falls back from the kernel to the
plain version. ``first_order_recurrence.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu_torch.kernels import _build


def _coefficient(b: float) -> float:
    """b as the float32 the step multiplies by, as a Python float."""
    return float(np.float32(b))


def initial_state(u: torch.Tensor, state) -> torch.Tensor:
    """A recursion's carried state over u's last axis: `state` as a tensor of
    u's type on u's device, or zeros of u's leading shape."""
    if state is None:
        return u.new_zeros(u.shape[:-1])
    return torch.as_tensor(state, dtype=u.dtype, device=u.device)


def first_order_recurrence(u: torch.Tensor, b: float, state=None) -> torch.Tensor:
    """Plain version: (..., N) float32 or complex64 -> y of the same shape,
    one step a sample, the product b·y[n-1] rounded and then the sum."""
    y = initial_state(u, state)
    coef = _coefficient(b)
    ys = []
    for t in range(u.shape[-1]):
        y = u[..., t] + coef * y
        ys.append(y)
    if not ys:
        return u.new_zeros(u.shape)
    return torch.stack(ys, dim=-1)


first_order_recurrence.launches = 0  # launches of the Hopper kernel


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("first_order_iir").r4w_first_order_iir
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float,
                                                                       ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def first_order_recurrence_cuda(u: torch.Tensor, b: float, state=None) -> torch.Tensor:
    """Hopper kernel: (B, N) float32 or complex64, with an optional (B,) state
    of u's type -> (B, N)."""
    if u.device.type != "cuda":
        raise ValueError(f"first_order_recurrence_cuda needs a tensor on a CUDA device, got "
                         f"{u.device}")
    if u.dtype not in (REAL_DTYPE, IQ_DTYPE):
        raise TypeError(f"first_order_recurrence_cuda takes float32 or complex64, got {u.dtype}")
    if u.ndim != 2 or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous (rows, N) tensor, got {tuple(u.shape)}")
    rows, n = u.shape
    if state is not None:
        state = torch.as_tensor(state, dtype=u.dtype, device=u.device)
        if state.shape != (rows,):
            raise ValueError(f"the state must be ({rows},), got {tuple(state.shape)}")
        state = state.contiguous()
    out = torch.empty_like(u)
    if rows * n == 0:
        return out
    comps = 2 if u.is_complex() else 1
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(u.data_ptr(), None if state is None else state.data_ptr(),
                        out.data_ptr(), rows, n, comps, _coefficient(b), stream)
    if err != 0:
        raise RuntimeError(f"r4w_first_order_iir launch failed with cudaError {err}")
    first_order_recurrence.launches += 1
    return out


def first_order_recurrence_dispatch(u: torch.Tensor, b: float, state=None) -> torch.Tensor:
    """(..., N) float32 or complex64 with an optional (...) state -> y, by the
    samples' device.

    CPU: the plain version. CUDA: the Hopper kernel, on the leading axes
    flattened into rows. Any other device raises.
    """
    if u.device.type == "cpu":
        return first_order_recurrence(u, b, state)
    if u.device.type != "cuda":
        raise ValueError(f"no first_order_recurrence path for device {u.device}")
    lead, n = u.shape[:-1], u.shape[-1]
    rows = math.prod(lead)
    if state is not None:
        state = initial_state(u, state).expand(lead).reshape(rows)
    y = first_order_recurrence_cuda(u.reshape(rows, n).contiguous(), b, state)
    return y.reshape(u.shape)
