"""Fused LoRa dechirp + DFT power: plain PyTorch version and Hopper kernel.

The kernel, ``csrc/dechirp_power.cu``, replaces
``r4w_tpu/kernels/pallas_kernels.py:dechirp_power_mxu``. It computes
``|DFT(x·d)|²`` per row as a direct DFT with FP32 FMAs, against a (K,)
twiddle table in shared memory, and forms the dechirped row on load so it
never reaches device memory. It is FP32-compute-bound: the direct DFT does
8·K² flops per row for 12·K bytes of device traffic, 2K/3 flop/byte, above
the card's FP32 ridge for every K >= 32. TF32 and the tensor cores are left
out because the result must agree with an FP32 FFT to 1e-4 of the peak.

`dechirp_power_dispatch` is what the demodulator calls: the plain version
for a tensor on the CPU, the kernel for a tensor on a CUDA device, and an
error for anything else. It never falls back from the kernel to the plain
version. ``dechirp_power.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu_torch.kernels import _build

_MIN_K, _MAX_K = 32, 4096  # SF5 .. SF12


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    out = torch.empty((rows, k), dtype=REAL_DTYPE, device=samples.device)
    if rows == 0:
        return out
    twiddle = _twiddle(k, samples.device)
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(samples.data_ptr(), down.data_ptr(), twiddle.data_ptr(),
                        out.data_ptr(), rows, k, stream)
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
