"""First-order recursions: plain PyTorch versions and one Hopper kernel.

Every recursion here carries one float32 state y per row (and per
component of a complex row, a complex row being two real recursions) along
the last axis, from y[-1] = the carried state (zeros when there is none),
and takes one input sample u[n] a step. The step is one of five kinds, each
with the rounding of the reference's compiled ``lax.scan`` body, which
contracts a product and a sum into one fused multiply-add (FMA):

============== ========================================= ====================
kind           step                                      coefficients
============== ========================================= ====================
linear         y = fma(b, y, u)                          b
one_pole       y = fma(a, u, round(b·y))                 a, b
ema            y = fma(a, round(u − y), y)               a
attack_release a = attack if u > y else release, then ema attack, release
peak_hold      y = max(u, round(decay·y))                decay
============== ========================================= ====================

`linear` is `filters.dc_blocker` (u = x[n] − x[n-1], b = α),
`filters2.de_emphasis` (u = x) and `adaptive.comb_feedback` (its polyphase
lanes as rows); `one_pole` is `filters.single_pole_iir` (u = x, a = α,
b = 1 − α); `ema` the stream probes; `attack_release` the envelope
followers and the noise gate's gain; `peak_hold` the decaying peak hold.
Each coefficient is rounded to float32, as the reference's Python floats
are where they meet float32 samples.

The plain version, `first_order_recurrence`, is a step loop over the
samples on the CPU, row by row, in Python floats, which reaches the
millions of steps a capture's row holds (about a microsecond a step; a
loop of tensor operations takes some 25). It computes each FMA as the
float64 product of two float32 values (exact) plus the float64 addend,
rounded once to float32; that equals the fused operation but for a tie of
the double rounding, about one in 2^29. The kernel,
``csrc/first_order_iir.cu``, has no Pallas counterpart: it stands for the
reference's ``lax.scan`` loops, which its compiler runs as one loop on its
device. It computes the same steps with `__fmaf_rn`, `__fmul_rn` and
`__fsub_rn`, which nvcc never contracts or splits, and equals the plain
version bit for bit. One warp walks a row, a lane a component, its input
staged ahead of the chain; the design is in the source's header.

`first_order_recurrence_dispatch` is what the filters and blocks call: the
plain version for a tensor on the CPU, the kernel for a tensor on a CUDA
device, and an error for anything else. It never falls back from the
kernel to the plain version. ``first_order_recurrence.launches`` counts
kernel launches, and ``first_order_recurrence.launches_by_kind`` counts
them by kind.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu_torch.kernels import _build

KINDS = ("linear", "one_pole", "ema", "attack_release", "peak_hold")  # the kernel's kind ids


def coefficient(c: float) -> float:
    """c as the float32 a step multiplies by, as a Python float."""
    return float(np.float32(c))


def initial_state(u: torch.Tensor, state) -> torch.Tensor:
    """A recursion's carried state over u's last axis: `state` as a tensor of
    u's type on u's device, or zeros of u's leading shape."""
    if state is None:
        return u.new_zeros(u.shape[:-1])
    return torch.as_tensor(state, dtype=u.dtype, device=u.device)


def _kind_id(kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown recursion kind {kind!r}; kinds are {KINDS}")
    return KINDS.index(kind)


def _planes(v: torch.Tensor) -> torch.Tensor:
    """float32 (..., C) view of float32 (C = 1) or complex64 (C = 2) values."""
    return torch.view_as_real(v) if v.is_complex() else v[..., None]


_F32 = struct.Struct("f")


def _walk(values: list, kind: str, a: float, b: float, y: float) -> list:
    """One component's chain in Python floats (float64), every float32
    rounding a pack to a 4-byte float: a product of two float32 values is
    exact in float64, so ``a * y + v`` rounded once to float32 is the fused
    multiply-add (up to a tie of the double rounding)."""
    pack, unpack = _F32.pack, _F32.unpack
    out = []
    put = out.append
    if kind == "linear":
        for v in values:
            y = unpack(pack(a * y + v))[0]
            put(y)
    elif kind == "one_pole":
        for v in values:
            y = unpack(pack(a * v + unpack(pack(b * y))[0]))[0]
            put(y)
    elif kind == "ema":
        for v in values:
            y = unpack(pack(a * unpack(pack(v - y))[0] + y))[0]
            put(y)
    elif kind == "attack_release":
        for v in values:
            y = unpack(pack((a if v > y else b) * unpack(pack(v - y))[0] + y))[0]
            put(y)
    else:  # peak_hold
        for v in values:
            held = unpack(pack(a * y))[0]
            y = v if v > held else held
            put(y)
    return out


def first_order_recurrence(u: torch.Tensor, kind: str, c0: float, c1: float = 0.0,
                           state=None) -> torch.Tensor:
    """Plain version: (..., N) float32 or complex64 on the CPU -> y of the
    same shape: one step of `kind` a sample, row by row and component by
    component, in Python floats with the kernel's roundings."""
    _kind_id(kind)
    if u.device.type != "cpu":
        raise ValueError(f"the plain recursion runs on the CPU, got {u.device}")
    if u.numel() == 0:
        return torch.empty_like(u)
    planes = _planes(u).reshape(-1, u.shape[-1], 2 if u.is_complex() else 1)
    y0 = _planes(initial_state(u, state).expand(u.shape[:-1])).reshape(planes.shape[0], -1)
    a, b = coefficient(c0), coefficient(c1)
    out = torch.empty(planes.shape, dtype=REAL_DTYPE)
    for row in range(planes.shape[0]):
        for comp in range(planes.shape[2]):
            out[row, :, comp] = torch.tensor(_walk(planes[row, :, comp].tolist(), kind, a, b,
                                                   float(y0[row, comp])), dtype=REAL_DTYPE)
    if u.is_complex():
        return torch.view_as_complex(out).reshape(u.shape)
    return out.reshape(u.shape)


first_order_recurrence.launches = 0  # launches of the Hopper kernel, all kinds
first_order_recurrence.launches_by_kind = dict.fromkeys(KINDS, 0)


def reset_launches() -> None:
    """Set the kernel's launch counters to 0."""
    first_order_recurrence.launches = 0
    first_order_recurrence.launches_by_kind = dict.fromkeys(KINDS, 0)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("first_order_iir").r4w_first_order_iir
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def first_order_recurrence_cuda(u: torch.Tensor, kind: str, c0: float, c1: float = 0.0,
                                state=None) -> torch.Tensor:
    """Hopper kernel: (B, N) float32 or complex64, with an optional (B,) state
    of u's type -> (B, N)."""
    kind_id = _kind_id(kind)
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
                        out.data_ptr(), rows, n, comps, kind_id, coefficient(c0),
                        coefficient(c1), stream)
    if err != 0:
        raise RuntimeError(f"r4w_first_order_iir launch failed with cudaError {err}")
    first_order_recurrence.launches += 1
    first_order_recurrence.launches_by_kind[kind] += 1
    return out


def first_order_recurrence_dispatch(u: torch.Tensor, kind: str, c0: float, c1: float = 0.0,
                                    state=None) -> torch.Tensor:
    """(..., N) float32 or complex64 with an optional (...) state -> y, by the
    samples' device.

    CPU: the plain version. CUDA: the Hopper kernel, on the leading axes
    flattened into rows. Any other device raises.
    """
    if u.device.type == "cpu":
        return first_order_recurrence(u, kind, c0, c1, state)
    if u.device.type != "cuda":
        raise ValueError(f"no first_order_recurrence path for device {u.device}")
    lead, n = u.shape[:-1], u.shape[-1]
    rows = math.prod(lead)
    if state is not None:
        state = initial_state(u, state).expand(lead).reshape(rows)
    y = first_order_recurrence_cuda(u.reshape(rows, n).contiguous(), kind, c0, c1, state)
    return y.reshape(u.shape)
