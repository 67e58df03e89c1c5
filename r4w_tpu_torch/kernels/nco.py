"""Oscillator mix (NCO): plain PyTorch version and Hopper kernel.

The kernel, ``csrc/nco_mix.cu``, replaces
``r4w_tpu/kernels/pallas_kernels.py:nco_mix`` (:244). Both compute
``x·gain·e^{j·ph}`` with ``ph[n] = ω·float(n) + φ₀`` along the last axis
(n restarts at 0 in every row), the carrier made on the fly and never
stored. ω = float32(2π·f/fs), φ₀ and the gain are rounded to float32 on
the host, and the phase takes the reference's float32 roundings: the
product rounded, then the sum rounded, never one fused multiply-add. At
the phases a long stream reaches, one ulp of the phase is a sizeable
angle, so a fused product-sum would already be visible. The kernel is
bound by device-memory bytes: a thread computes the carrier of its column
(or column pair) once and applies it to a tile of ROW_TILE rows, as the
plain version builds the carrier once for all rows. `nco_plan` lays out
the launch; the design is in the source's header.

`nco_mix_dispatch` is what the mixers call: the plain version for a
tensor on the CPU, the kernel for a tensor on a CUDA device, and an error
for anything else. It never falls back from the kernel to the plain
version. `nco_rotate`, `nco_rotate_cuda` and `nco_rotate_dispatch` are the
same three with ω given in radians per sample (a phase rotator's increment,
rounded to float32 and nothing else), which spares a caller the division
f/fs that could round ω to another float32. ``nco_mix.launches`` counts
kernel launches of both.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu_torch.kernels import _build


THREADS = 256       # a block of the kernel
ROW_TILE = 8        # rows that share one carrier, kRowTile in the kernel
MAX_GRID_Y = 65535  # row tiles past it are walked with a stride


class NcoPlan(NamedTuple):
    """One launch of the NCO kernel."""
    row_tile: int   # rows a thread walks with one carrier
    blocks_x: int   # blocks of THREADS columns (or column pairs)
    blocks_y: int   # blocks of row tiles, at most MAX_GRID_Y
    pairs: bool     # a thread moves columns (2p, 2p+1) with 16-byte accesses


def nco_plan(rows: int, n: int, aligned: bool) -> NcoPlan:
    """The host's plan for (rows, n) complex64 samples: column pairs when n is
    even and both pointers are 16-byte aligned (`aligned`), else one column a
    thread; one block row per tile of ROW_TILE rows, up to MAX_GRID_Y."""
    pairs = aligned and n % 2 == 0
    items = n // 2 if pairs else n
    return NcoPlan(ROW_TILE, max(1, -(-items // THREADS)),
                   max(1, min(-(-rows // ROW_TILE), MAX_GRID_Y)), pairs)


def omega(freq_hz: float, sample_rate: float) -> float:
    """Radians per sample, float32(2π·f/fs), as a Python float."""
    return float(np.float32(2.0 * np.pi * freq_hz / sample_rate))


def _f32(value: float) -> float:
    """`value` rounded to float32, as a Python float."""
    return float(np.float32(value))


def rotor_phase(n: int, w: float, phase0: float = 0.0, device=None) -> torch.Tensor:
    """(n,) float32 phase ω·float(j) + φ₀ with ω = float32(w): the product and
    the sum each rounded."""
    index = torch.arange(n, dtype=REAL_DTYPE, device=device)
    return index * _f32(w) + _f32(phase0)


def nco_phase(n: int, freq_hz: float, sample_rate: float, phase0: float = 0.0,
              device=None) -> torch.Tensor:
    """(n,) float32 phase ω·float(j) + φ₀: the product and the sum each rounded."""
    return rotor_phase(n, omega(freq_hz, sample_rate), phase0, device)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("nco_mix").r4w_nco_mix
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def nco_rotate(x: torch.Tensor, w: float, phase0: float = 0.0,
               gain: float = 1.0) -> torch.Tensor:
    """Plain version: (..., N) complex64 -> x·(gain·cis(ph)), ph from `rotor_phase`."""
    ph = rotor_phase(x.shape[-1], w, phase0, device=x.device)
    return x * (_f32(gain) * cis(ph))


def nco_mix(x: torch.Tensor, freq_hz: float, sample_rate: float, phase0: float = 0.0,
            gain: float = 1.0) -> torch.Tensor:
    """Plain version: (..., N) complex64 -> x·(gain·cis(ph)), ph from `nco_phase`."""
    return nco_rotate(x, omega(freq_hz, sample_rate), phase0, gain)


nco_mix.launches = 0  # launches of the Hopper kernel, counted by nco_rotate_cuda


def nco_mix_cuda(x: torch.Tensor, freq_hz: float, sample_rate: float, phase0: float = 0.0,
                 gain: float = 1.0) -> torch.Tensor:
    """Hopper kernel: (B, N) complex64 -> (B, N) complex64."""
    return nco_rotate_cuda(x, omega(freq_hz, sample_rate), phase0, gain)


def nco_rotate_cuda(x: torch.Tensor, w: float, phase0: float = 0.0,
                    gain: float = 1.0) -> torch.Tensor:
    """Hopper kernel with ω = float32(w) rad/sample: (B, N) complex64 -> (B, N)."""
    if x.device.type != "cuda":
        raise ValueError(f"nco_mix_cuda needs a tensor on a CUDA device, got {x.device}")
    if x.dtype != IQ_DTYPE:
        raise TypeError(f"nco_mix_cuda takes complex64, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"x must be (rows, N), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("nco_mix_cuda needs a contiguous tensor")
    rows, n = x.shape
    out = torch.empty_like(x)
    if rows * n == 0:
        return out
    plan = nco_plan(rows, n, (x.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), out.data_ptr(), rows, n, _f32(w), _f32(phase0),
                        _f32(gain), plan.blocks_x, plan.blocks_y, int(plan.pairs), stream)
    if err != 0:
        raise RuntimeError(f"r4w_nco_mix launch failed with cudaError {err}")
    nco_mix.launches += 1
    return out


def nco_mix_dispatch(x: torch.Tensor, freq_hz: float, sample_rate: float, phase0: float = 0.0,
                     gain: float = 1.0) -> torch.Tensor:
    """(..., N) complex64 mixed by the oscillator, by the samples' device.

    CPU: the plain version. CUDA: the Hopper kernel, on the leading axes
    flattened into rows. Any other device raises.
    """
    return nco_rotate_dispatch(x, omega(freq_hz, sample_rate), phase0, gain)


def nco_rotate_dispatch(x: torch.Tensor, w: float, phase0: float = 0.0,
                        gain: float = 1.0) -> torch.Tensor:
    """(..., N) complex64 rotated by ω = float32(w) rad/sample from φ₀, by the
    samples' device, as `nco_mix_dispatch`."""
    if x.device.type == "cpu":
        return nco_rotate(x, w, phase0, gain)
    if x.device.type != "cuda":
        raise ValueError(f"no nco_mix path for device {x.device}")
    lead, n = x.shape[:-1], x.shape[-1]
    y = nco_rotate_cuda(x.reshape(math.prod(lead), n).contiguous(), w, phase0, gain)
    return y.reshape(x.shape)
