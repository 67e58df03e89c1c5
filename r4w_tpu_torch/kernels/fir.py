"""FIR filter with decimation: plain PyTorch version and Hopper kernel.

The kernel, ``csrc/fir_decimate.cu``, replaces
``r4w_tpu/kernels/pallas_kernels.py:fir_decimate`` (:185, with its core
``_fir_pallas_1x``). Both compute the correlation form
``y[..., j] = Σ_t taps[t]·x[..., j·f + t]`` for the ⌊(N − K)/f⌋ + 1 kept
outputs only; flip the taps for a convolution. The kernel takes a batch of
rows, real float32 or complex64 input, any K ≥ 1 and any f ≥ 1, and sums
in tap order with FP32 FMAs (no TF32, no tensor cores). It is bound by
device-memory bytes; its design is in the source's header.

`fir_decimate_dispatch` is what the filters call: the plain version for a
tensor on the CPU, the kernel for a tensor on a CUDA device, and an error
for anything else. It never falls back from the kernel to the plain
version. ``fir_decimate.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu_torch.kernels import _build


def n_outputs(n: int, k: int, factor: int) -> int:
    """Outputs of a 'valid' correlation of N samples with K taps, kept every f-th."""
    return max((n - k) // factor + 1, 0)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("fir_decimate").r4w_fir_decimate
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_factor(k: int, factor: int) -> None:
    if k < 1 or factor < 1:
        raise ValueError(f"fir_decimate needs K >= 1 taps and factor >= 1, got K={k}, "
                         f"factor={factor}")


def fir_decimate(x: torch.Tensor, taps: torch.Tensor, factor: int = 1) -> torch.Tensor:
    """Plain version: (..., N) real or complex × (K,) float32 taps -> (..., n_out).

    The K-term shift-add over strided slices, in tap order; a complex
    signal is filtered as its (real, imaginary) pairs in one pass.
    """
    k, n = taps.shape[-1], x.shape[-1]
    _check_factor(k, factor)
    n_out = n_outputs(n, k, factor)
    planes = torch.view_as_real(x) if x.is_complex() else x.unsqueeze(-1)
    span = (n_out - 1) * factor + 1
    acc = planes.new_zeros(planes.shape[:-2] + (n_out, planes.shape[-1]))
    if n_out:
        for t in range(k):
            acc = acc + taps[t] * planes[..., t:t + span:factor, :]
    return torch.view_as_complex(acc) if x.is_complex() else acc.squeeze(-1)


fir_decimate.launches = 0  # launches of the Hopper kernel, counted by fir_decimate_cuda


def fir_decimate_cuda(x: torch.Tensor, taps: torch.Tensor, factor: int = 1) -> torch.Tensor:
    """Hopper kernel: (B, N) float32 or complex64 × (K,) float32 -> (B, n_out)."""
    if x.device.type != "cuda" or taps.device != x.device:
        raise ValueError(f"fir_decimate_cuda needs both tensors on one CUDA device, "
                         f"got {x.device} and {taps.device}")
    if x.dtype not in (REAL_DTYPE, IQ_DTYPE) or taps.dtype != REAL_DTYPE:
        raise TypeError(f"fir_decimate_cuda takes float32 or complex64 samples and float32 "
                        f"taps, got {x.dtype} and {taps.dtype}")
    if x.ndim != 2 or taps.ndim != 1:
        raise ValueError(f"x must be (rows, N) and taps (K,), got {tuple(x.shape)} and "
                         f"{tuple(taps.shape)}")
    if not (x.is_contiguous() and taps.is_contiguous()):
        raise ValueError("fir_decimate_cuda needs contiguous tensors")
    (rows, n), k = x.shape, taps.shape[0]
    _check_factor(k, factor)
    if k >= 2 ** 31 or factor >= 2 ** 31:
        raise ValueError(f"K and factor must fit in 32 bits, got {k} and {factor}")
    n_out = n_outputs(n, k, factor)
    out = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    if rows == 0 or n_out == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), taps.data_ptr(), out.data_ptr(), rows, n, k, factor,
                        n_out, int(x.is_complex()), stream)
    if err != 0:
        raise RuntimeError(f"r4w_fir_decimate launch failed with cudaError {err}")
    fir_decimate.launches += 1
    return out


def fir_decimate_dispatch(x: torch.Tensor, taps: torch.Tensor, factor: int = 1) -> torch.Tensor:
    """(..., N) × (K,) taps -> (..., n_out), by the samples' device.

    CPU: the plain version. CUDA: the Hopper kernel, on the leading axes
    flattened into rows. Any other device raises.
    """
    if x.device.type == "cpu":
        return fir_decimate(x, taps, factor)
    if x.device.type != "cuda":
        raise ValueError(f"no fir_decimate path for device {x.device}")
    lead, n = x.shape[:-1], x.shape[-1]
    y = fir_decimate_cuda(x.reshape(math.prod(lead), n).contiguous(), taps.contiguous(), factor)
    return y.reshape(*lead, y.shape[-1])
