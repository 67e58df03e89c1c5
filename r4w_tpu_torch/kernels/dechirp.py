"""Fused LoRa dechirp + FFT power: plain PyTorch version and Hopper kernel.

The kernel, ``csrc/dechirp_power.cu``, replaces
``r4w_tpu/kernels/pallas_kernels.py:dechirp_power_mxu``. It computes
``|FFT(x·d)|²`` per row as a Stockham FFT in shared memory: each thread
holds 16 points in registers, radix-16 passes and one pass of the radix
left over exchange them through shared memory, and the dechirped row and
the spectrum never reach device memory. Done as an FFT the function is
bound by device-memory bytes (8 B in and 4 B out per element), so the
kernel loads 16 bytes a thread, coalesced, and stores the power coalesced
after the last pass. Twiddles come from the float64-built table
`_twiddle_np`; FP32 FMAs only, so the result agrees with an FP32 FFT to
1e-4 of the peak.

`launch_plan` is the host's choice of block per K: 256 threads, K/16 of
them a row, so a block holds 4096/K rows (one row at K = 4096).

`dechirp_power_dispatch` is what the demodulator calls: the plain version
for a tensor on the CPU, the kernel for a tensor on a CUDA device, and an
error for anything else. It never falls back from the kernel to the plain
version. ``dechirp_power.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu_torch.kernels import _build

_MIN_K, _MAX_K = 32, 4096  # SF5 .. SF12
POINTS = 16                # points a thread holds and widest radix: kPoints of the kernel
BLOCK_THREADS = 256


class LaunchPlan(NamedTuple):
    """One launch of the kernel at one K."""
    threads: int         # a block
    rows_per_block: int
    smem_bytes: int      # the padded real and imaginary planes of the block's points
    radices: tuple       # of the FFT's passes, in order


def launch_plan(k: int) -> LaunchPlan:
    """The block the host launches for rows of K points: BLOCK_THREADS threads,
    K / POINTS a row; radix-POINTS passes, then the radix left over."""
    if k < _MIN_K or k > _MAX_K or k & (k - 1):
        raise ValueError(f"K must be a power of two in [{_MIN_K}, {_MAX_K}], got {k}")
    per_row = k // POINTS
    rows_per_block = max(1, BLOCK_THREADS // per_row)
    n = rows_per_block * k
    radices, left = [], k
    while left > 1:
        radices.append(min(POINTS, left))
        left //= radices[-1]
    return LaunchPlan(per_row * rows_per_block, rows_per_block, 2 * 4 * (n + (n >> 5)),
                      tuple(radices))


@functools.lru_cache(maxsize=None)
def _twiddle_np(k: int) -> np.ndarray:
    """exp(-2πi·m/k) for m < k, in float64 as `_dft_mats` builds its matrices."""
    return np.exp(-2j * np.pi * np.arange(k) / k).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _twiddle(k: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_twiddle_np(k)).to(device)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("dechirp_power").r4w_dechirp_power
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dechirp_power(samples: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Plain version: (..., K) complex × (K,) downchirp -> (..., K) float32 |FFT|²."""
    spectrum = torch.fft.fft(samples.to(IQ_DTYPE) * down, dim=-1)
    return spectrum.real ** 2 + spectrum.imag ** 2


dechirp_power.launches = 0  # launches of the Hopper kernel, counted by dechirp_power_cuda


def dechirp_power_cuda(samples: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Hopper kernel: (R, K) complex64 rows × (K,) downchirp -> (R, K) float32."""
    if samples.device.type != "cuda" or down.device != samples.device:
        raise ValueError(f"dechirp_power_cuda needs both tensors on one CUDA device, "
                         f"got {samples.device} and {down.device}")
    if samples.dtype != IQ_DTYPE or down.dtype != IQ_DTYPE:
        raise TypeError(f"dechirp_power_cuda takes complex64, got {samples.dtype} "
                        f"and {down.dtype}")
    if samples.ndim != 2:
        raise ValueError(f"samples must be (rows, K), got {tuple(samples.shape)}")
    rows, k = samples.shape
    if k < _MIN_K or k > _MAX_K or k & (k - 1) or tuple(down.shape) != (k,):
        raise ValueError(f"K must be a power of two in [{_MIN_K}, {_MAX_K}] and down "
                         f"(K,), got samples {tuple(samples.shape)}, down "
                         f"{tuple(down.shape)}")
    if rows >= 2 ** 31:
        raise ValueError(f"too many rows for one launch: {rows}")
    if not (samples.is_contiguous() and down.is_contiguous()):
        raise ValueError("dechirp_power_cuda needs contiguous tensors")
    # the kernel loads 16 bytes at a time; a view may start 8 bytes off
    samples, down = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (samples, down))
    out = torch.empty((rows, k), dtype=REAL_DTYPE, device=samples.device)
    if rows == 0:
        return out
    twiddle = _twiddle(k, samples.device)
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(samples.data_ptr(), down.data_ptr(), twiddle.data_ptr(),
                        out.data_ptr(), rows, k, launch_plan(k).rows_per_block, stream)
    if err != 0:
        raise RuntimeError(f"r4w_dechirp_power launch failed with cudaError {err}")
    dechirp_power.launches += 1
    return out


def dechirp_power_dispatch(samples: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """(R, K) complex64 rows × (K,) downchirp -> (R, K) power, by the samples' device.

    CPU: the plain version. CUDA: the Hopper kernel. Any other device raises.
    """
    if samples.device.type == "cpu":
        return dechirp_power(samples, down)
    if samples.device.type != "cuda":
        raise ValueError(f"no dechirp_power path for device {samples.device}")
    return dechirp_power_cuda(samples.contiguous(), down.contiguous())
