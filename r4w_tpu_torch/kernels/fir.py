"""FIR filter with decimation: plain PyTorch version and Hopper kernel.

The kernel, ``csrc/fir_decimate.cu``, replaces
``r4w_tpu/kernels/pallas_kernels.py:fir_decimate`` (:185, with its core
``_fir_pallas_1x``). Both compute the correlation form
``y[..., j] = Σ_t taps[t]·v[..., j·f + t]`` for the ⌊(S + N − K)/f⌋ + 1
kept outputs only, over the stream v = state ‖ x: the S = K − 1 samples of
a filter's carried state (`state`, or zeros with ``zero_state=True``)
before the N samples of x, or x alone (S = 0). Flip the taps for a
convolution. The kernel reads the state and x as two pointers, so nothing
concatenates them on the card, and a zero state is never allocated. It
takes a batch of rows, real float32 or complex64 input, any K ≥ 1 and any
f ≥ 1, and sums with FP32 FMAs (no TF32, no tensor cores). `fir_plan` lays
out its launch; the design is in the source's header.

`fir_decimate_dispatch` is what the filters call: the plain version for a
tensor on the CPU, the kernel for a tensor on a CUDA device, and an error
for anything else. It never falls back from the kernel to the plain
version. ``fir_decimate.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu_torch.kernels import _build

THREADS = (256, 128, 64, 32)  # block sizes the plan tries, largest first
REGISTER_BLOCK = 9            # consecutive outputs a thread keeps in registers, kR
STEP = 8                      # taps a window step applies, kStep in the kernel
MAX_CHUNK = 256               # taps staged per pass, kMaxChunk
SMEM_BUDGET = 48 * 1024       # shared memory a block may use, kSmemBudget


class FirPlan(NamedTuple):
    """One launch of the FIR kernel: a block per tile of threads ·
    REGISTER_BLOCK outputs of a row."""
    threads: int  # threads a block
    chunk: int    # taps staged per pass
    entries: int  # plane stride in shared memory, in samples
    smem: int     # dynamic shared memory a block, bytes


def n_outputs(n: int, k: int, factor: int) -> int:
    """Outputs of a 'valid' correlation of N samples with K taps, kept every f-th."""
    return max((n - k) // factor + 1, 0)


def fir_plan(k: int, factor: int, sample_bytes: int) -> FirPlan:
    """The host's plan: the longest tap chunk (up to MAX_CHUNK) and then the
    largest block whose shared memory fits SMEM_BUDGET: each of the chunk's
    (at most f) polyphase planes holds its ⌈chunk/f⌉ taps padded to STEP and
    threads · REGISTER_BLOCK + ⌈chunk/f⌉ − 1 window samples. The chunk halves
    until one fits (one tap and 32 threads always do)."""
    chunk = min(k, MAX_CHUNK)
    while True:
        planes, q = min(factor, chunk), -(-chunk // factor)
        tap_stride = -(-q // STEP) * STEP
        for threads in THREADS:
            entries = threads * REGISTER_BLOCK + q - 1
            smem = planes * (4 * tap_stride + sample_bytes * entries)
            if smem <= SMEM_BUDGET:
                return FirPlan(threads, chunk, entries, smem)
        chunk = (chunk + 1) // 2


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load_library("fir_decimate").r4w_fir_decimate
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_factor(k: int, factor: int) -> None:
    if k < 1 or factor < 1:
        raise ValueError(f"fir_decimate needs K >= 1 taps and factor >= 1, got K={k}, "
                         f"factor={factor}")


def _state_len(x: torch.Tensor, k: int, state, zero_state: bool) -> int:
    """S, the samples the stream holds before x: K − 1 with a state, else 0."""
    if state is None:
        return k - 1 if zero_state else 0
    if zero_state:
        raise ValueError("pass a state or zero_state=True, not both")
    want = x.shape[:-1] + (k - 1,)
    if state.shape != want or state.dtype != x.dtype or state.device != x.device:
        raise ValueError(f"the state must be {tuple(want)} {x.dtype} on {x.device}, got "
                         f"{tuple(state.shape)} {state.dtype} on {state.device}")
    return k - 1


def fir_decimate(x: torch.Tensor, taps: torch.Tensor, factor: int = 1, state=None, *,
                 zero_state: bool = False) -> torch.Tensor:
    """Plain version: (..., N) real or complex × (K,) float32 taps -> (..., n_out).

    Concatenates the state (or K − 1 zeros) before x, then takes the K-term
    shift-add over strided slices, in tap order; a complex signal is
    filtered as its (real, imaginary) pairs in one pass.
    """
    k = taps.shape[-1]
    _check_factor(k, factor)
    s = _state_len(x, k, state, zero_state)
    if s:
        head = x.new_zeros(x.shape[:-1] + (s,)) if state is None else state
        x = torch.cat([head, x], dim=-1)
    n_out = n_outputs(x.shape[-1], k, factor)
    planes = torch.view_as_real(x) if x.is_complex() else x.unsqueeze(-1)
    span = (n_out - 1) * factor + 1
    acc = planes.new_zeros(planes.shape[:-2] + (n_out, planes.shape[-1]))
    if n_out:
        for t in range(k):
            acc = acc + taps[t] * planes[..., t:t + span:factor, :]
    return torch.view_as_complex(acc) if x.is_complex() else acc.squeeze(-1)


fir_decimate.launches = 0  # launches of the Hopper kernel, counted by fir_decimate_cuda


def fir_decimate_cuda(x: torch.Tensor, taps: torch.Tensor, factor: int = 1, state=None, *,
                      zero_state: bool = False) -> torch.Tensor:
    """Hopper kernel: (B, N) float32 or complex64 × (K,) float32, with an
    optional (B, K − 1) state of x's type -> (B, n_out)."""
    if x.device.type != "cuda" or taps.device != x.device:
        raise ValueError(f"fir_decimate_cuda needs both tensors on one CUDA device, "
                         f"got {x.device} and {taps.device}")
    if x.dtype not in (REAL_DTYPE, IQ_DTYPE) or taps.dtype != REAL_DTYPE:
        raise TypeError(f"fir_decimate_cuda takes float32 or complex64 samples and float32 "
                        f"taps, got {x.dtype} and {taps.dtype}")
    if x.ndim != 2 or taps.ndim != 1:
        raise ValueError(f"x must be (rows, N) and taps (K,), got {tuple(x.shape)} and "
                         f"{tuple(taps.shape)}")
    if not (x.is_contiguous() and taps.is_contiguous()
            and (state is None or state.is_contiguous())):
        raise ValueError("fir_decimate_cuda needs contiguous tensors")
    (rows, n), k = x.shape, taps.shape[0]
    _check_factor(k, factor)
    if k >= 2 ** 31 or factor >= 2 ** 31:
        raise ValueError(f"K and factor must fit in 32 bits, got {k} and {factor}")
    s = _state_len(x, k, state, zero_state)
    n_out = n_outputs(s + n, k, factor)
    out = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    if rows == 0 or n_out == 0:
        return out
    plan = fir_plan(k, factor, x.element_size())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(state.data_ptr() if state is not None and s else None, x.data_ptr(),
                        taps.data_ptr(), out.data_ptr(), rows, s, n, k, factor, n_out,
                        int(x.is_complex()), plan.threads, plan.chunk, plan.entries, plan.smem,
                        stream)
    if err != 0:
        raise RuntimeError(f"r4w_fir_decimate launch failed with cudaError {err}")
    fir_decimate.launches += 1
    return out


def fir_decimate_dispatch(x: torch.Tensor, taps: torch.Tensor, factor: int = 1, state=None, *,
                          zero_state: bool = False) -> torch.Tensor:
    """(..., N) × (K,) taps, with an optional (..., K − 1) state -> (..., n_out),
    by the samples' device.

    CPU: the plain version. CUDA: the Hopper kernel, on the leading axes
    flattened into rows. Any other device raises.
    """
    if x.device.type == "cpu":
        return fir_decimate(x, taps, factor, state, zero_state=zero_state)
    if x.device.type != "cuda":
        raise ValueError(f"no fir_decimate path for device {x.device}")
    lead, n = x.shape[:-1], x.shape[-1]
    rows = math.prod(lead)
    s = _state_len(x, taps.shape[-1], state, zero_state)
    if state is not None:
        state = state.reshape(rows, s).contiguous()
    y = fir_decimate_cuda(x.reshape(rows, n).contiguous(), taps.contiguous(), factor, state,
                          zero_state=zero_state)
    return y.reshape(*lead, y.shape[-1])
