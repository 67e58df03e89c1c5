"""Viterbi forward ACS and survivor traceback: plain PyTorch versions and Hopper kernels.

The kernels, ``csrc/viterbi.cu``, replace
``r4w_tpu/kernels/pallas_kernels.py:viterbi_forward`` (:403) and
``viterbi_traceback`` (:479). Both are bound by device-memory bytes once
latency is hidden: the forward pass reads the (T, C, L) branch metrics and
writes the (T, G, L) packed decisions, a few FP32 adds and compares per
byte; the traceback reads one decision word and writes one bit per (step,
lane). The TPU kernel's point was to keep the path metrics on chip for the
whole frame, and so do these. The forward kernel spreads each lane's S
states over a group of min(S/2, 32) threads, one butterfly each (a warp
per lane at K = 7): a step is a round of warp shuffles for the
predecessors' metrics, the add-compare-selects, and ballots whose bits are
the decision words. A block holds a few lanes (`forward_plan`) and stages
chunks of steps through shared memory, the branch metrics double-buffered
with ``cp.async`` and the decisions written back as rows. The traceback
runs one thread per lane, 32 lanes a block, and brings the decisions into
a ring of shared-memory stages with ``cp.async`` from the top of the frame
down (`traceback_plan`); each step reads its one word there by address,
and the state at the top of a group of four steps names the words of all
four, so the serial chain is a few integer ops a step. The TPU's 0/1
selection matmuls, bf16 3-split and decision-pack matmul existed only
because Mosaic has no gather, and are not carried over.

Layouts are the reference kernels': branch metrics ``bm`` (T, C, L)
float32 with C = 2^R; decisions (T, G, L) int32, the decision of target
state s' in bit s' mod w of word s' // w, w = 16 (or S when S < 16);
final metrics (S, L) float32; bits (T, L) int32. Metrics start at 0 for
state 0 and -1e9 elsewhere and are never renormalised. Target
s' = b·S/2 + m takes max(M[2m] + bm[code(2m, b)], M[2m+1] + bm[code(2m+1, b)]);
its decision is 1 when the odd predecessor is strictly larger, so ties go
to the even one, as ``jnp.argmax`` does. FP32 adds and compares only, so
the kernels equal the plain versions bit for bit.

The ``*_dispatch`` functions are what the decoder calls: the plain version
for a tensor on the CPU, the kernel for a tensor on a CUDA device, an
error for anything else, and never a fallback from the kernel to the plain
version. ``viterbi_forward.launches`` and ``viterbi_traceback.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from r4w_tpu_torch.core.types import REAL_DTYPE, SYMBOL_DTYPE
from r4w_tpu_torch.kernels import _build

MIN_CONSTRAINT, MAX_CONSTRAINT = 3, 8  # what the kernels are built for
RATES = (2, 3)                          # outputs per input bit, R
UNREACHED = -1e9                        # initial metric of every state but 0
BLOCK_THREADS = 256        # the forward kernel's block, where there are lanes enough
MAX_LANES_PER_BLOCK = 32   # a staged row of one (step, codeword) is at most 128 bytes
MAX_CHUNK = 32             # steps staged at a time
STATIC_SMEM_BYTES = 48 * 1024
TRACEBACK_LANES = 32       # the traceback's block: one warp, a thread per lane
TRACEBACK_STAGES = 3       # chunks in the traceback's ring, kTracebackStages in the kernel
TRACEBACK_CHUNK_BYTES = 16 * 1024


def _check_code(constraint: int, polys) -> None:
    """Raise unless the kernels take this code: 3 <= K <= 8, R in {2, 3}."""
    if not MIN_CONSTRAINT <= constraint <= MAX_CONSTRAINT or len(polys) not in RATES:
        raise ValueError(f"the Viterbi kernels take {MIN_CONSTRAINT} <= K <= "
                         f"{MAX_CONSTRAINT} and R in {RATES}, got K={constraint}, "
                         f"R={len(polys)}")
    if any(not 0 < p < (1 << constraint) for p in polys):
        raise ValueError(f"polynomials must be nonzero and below 2^K, got {polys}")


@functools.lru_cache(maxsize=None)
def code_index(constraint: int, polys: tuple[int, ...]) -> np.ndarray:
    """(S, 2) int32: the codeword index, generator r at bit r, emitted from
    state st on input bit b (register (b << K-1) | st)."""
    s = 1 << (constraint - 1)
    reg = (np.arange(2)[None, :] << (constraint - 1)) | np.arange(s)[:, None]
    idx = np.zeros((s, 2), np.int32)
    for r, p in enumerate(polys):
        idx |= np.vectorize(lambda v, p=p: bin(v & p).count("1") & 1)(reg) << r
    return idx.astype(np.int32)


def word_width(constraint: int) -> int:
    """Decisions packed per int32 word: 16, or S when S < 16."""
    return min(16, 1 << (constraint - 1))


class ForwardPlan(NamedTuple):
    """One launch of the forward kernel."""
    group: int            # threads a lane: min(S/2, 32)
    lanes_per_block: int
    chunk: int            # steps staged in shared memory at a time
    threads: int          # a block
    smem_bytes: int       # two chunks of branch metrics and one of decision ballots


def forward_plan(constraint: int, n_codes: int, lanes: int) -> ForwardPlan:
    """The host's plan for the forward kernel: BLOCK_THREADS threads a block
    (at most MAX_LANES_PER_BLOCK lanes) where the lanes fill it, else one
    warp a block, and the longest chunk of steps whose staging fits 48 KB of
    shared memory. The kernel is built for these two block shapes."""
    s = 1 << (constraint - 1)
    group = min(s // 2, 32)
    full = min(BLOCK_THREADS // group, MAX_LANES_PER_BLOCK)  # the kernel's two block shapes
    lanes_per_block = full if lanes >= full else 32 // group
    threads = group * lanes_per_block
    # per step: the lanes' branch metrics twice (double buffer), each warp's S/group ballots
    step_bytes = 4 * (2 * n_codes * lanes_per_block + threads // 32 * (s // group))
    chunk = MAX_CHUNK
    while chunk > 1 and chunk * step_bytes > STATIC_SMEM_BYTES:
        chunk //= 2
    return ForwardPlan(group, lanes_per_block, chunk, threads, chunk * step_bytes)


class TracebackPlan(NamedTuple):
    """One launch of the traceback kernel."""
    chunk: int       # steps staged in shared memory at a time
    stages: int      # chunks in the ring: one walked, the others in flight
    smem_bytes: int  # the ring
    blocks: int      # of TRACEBACK_LANES lanes


def traceback_plan(constraint: int, lanes: int) -> TracebackPlan:
    """The host's plan for the traceback: chunks of TRACEBACK_CHUNK_BYTES, G
    words of TRACEBACK_LANES lanes a step (32 steps at K = 7, 16 at K = 8),
    TRACEBACK_STAGES of them in shared memory, one block per 32 lanes."""
    row_bytes = 4 * TRACEBACK_LANES * ((1 << (constraint - 1)) // word_width(constraint))
    chunk = TRACEBACK_CHUNK_BYTES // row_bytes
    return TracebackPlan(chunk, TRACEBACK_STAGES, TRACEBACK_STAGES * chunk * row_bytes,
                         -(-lanes // TRACEBACK_LANES))


@functools.lru_cache(maxsize=None)
def _code_index_t(constraint: int, polys: tuple[int, ...], device: torch.device):
    return torch.from_numpy(code_index(constraint, polys)).long().to(device)


def viterbi_forward(bm: torch.Tensor, constraint: int, polys) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: bm (T, C, L) float32 -> (decisions (T, G, L) int32,
    final metrics (S, L) float32), a Python loop over the T steps."""
    steps, _, lanes = bm.shape
    s = 1 << (constraint - 1)
    w = word_width(constraint)
    code = _code_index_t(constraint, tuple(polys), bm.device)
    shift = (torch.arange(s, device=bm.device, dtype=SYMBOL_DTYPE) % w)[:, None]
    metrics = torch.full((s, lanes), UNREACHED, dtype=REAL_DTYPE, device=bm.device)
    metrics[0] = 0.0
    dec = torch.empty((steps, s // w, lanes), dtype=SYMBOL_DTYPE, device=bm.device)
    for t in range(steps):
        cand = metrics[:, None, :] + bm[t][code]       # (S, 2, L): [st, b]
        even, odd = cand[0::2], cand[1::2]             # (S/2, 2, L): [m, b]
        take_odd = odd > even
        # target s' = b·S/2 + m
        metrics = torch.where(take_odd, odd, even).transpose(0, 1).reshape(s, lanes)
        bits = take_odd.transpose(0, 1).reshape(s, lanes).to(SYMBOL_DTYPE) << shift
        dec[t] = bits.reshape(s // w, w, lanes).sum(dim=1, dtype=SYMBOL_DTYPE)
    return dec, metrics


def viterbi_traceback(dec: torch.Tensor, constraint: int, polys,
                      start_state: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: decisions (T, G, L) int32 -> input bits (T, L) int32,
    walking back from `start_state` (L,) (default: state 0, a terminated
    trellis). Flush bits are included; the caller slices them off."""
    steps, _, lanes = dec.shape
    half = 1 << (constraint - 2)
    w = word_width(constraint)
    state = (torch.zeros(lanes, dtype=torch.long, device=dec.device) if start_state is None
             else start_state.to(device=dec.device, dtype=torch.long))
    bits = torch.empty((steps, lanes), dtype=SYMBOL_DTYPE, device=dec.device)
    for t in range(steps - 1, -1, -1):
        bits[t] = state >> (constraint - 2)
        word = dec[t].gather(0, (state // w)[None])[0].long()
        state = 2 * (state & (half - 1)) + ((word >> (state % w)) & 1)
    return bits


viterbi_forward.launches = 0    # launches of the Hopper kernel, counted by viterbi_forward_cuda
viterbi_traceback.launches = 0  # counted by viterbi_traceback_cuda


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load_library("viterbi")
    forward = lib.r4w_viterbi_forward
    forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    forward.restype = ctypes.c_int
    traceback = lib.r4w_viterbi_traceback
    traceback.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    traceback.restype = ctypes.c_int
    return forward, traceback


def _check_cuda(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got one on {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous 3-D tensor, got {tuple(x.shape)}")
    if x.numel() >= 2 ** 31 or max(x.shape) >= 2 ** 31:
        raise ValueError(f"{name}: tensor too large for one launch: {tuple(x.shape)}")


def viterbi_forward_cuda(bm: torch.Tensor, constraint: int, polys) -> tuple[torch.Tensor, torch.Tensor]:
    """Hopper kernel: bm (T, C, L) float32 on a CUDA device -> (decisions, final metrics)."""
    polys = tuple(polys)
    _check_code(constraint, polys)
    _check_cuda("viterbi_forward_cuda", bm, REAL_DTYPE)
    steps, n_codes, lanes = bm.shape
    if n_codes != 1 << len(polys):
        raise ValueError(f"bm has {n_codes} codewords, R={len(polys)} needs {1 << len(polys)}")
    s = 1 << (constraint - 1)
    dec = torch.empty((steps, s // word_width(constraint), lanes), dtype=SYMBOL_DTYPE,
                      device=bm.device)
    final = torch.empty((s, lanes), dtype=REAL_DTYPE, device=bm.device)
    if lanes == 0:
        return dec, final
    code = code_index(constraint, polys)  # host memory: the launch copies it into kernel arguments
    plan = forward_plan(constraint, n_codes, lanes)
    with torch.cuda.device(bm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()[0](bm.data_ptr(), code.ctypes.data, dec.data_ptr(), final.data_ptr(),
                            steps, lanes, constraint, n_codes, plan.lanes_per_block, plan.chunk,
                            stream)
    if err != 0:
        raise RuntimeError(f"r4w_viterbi_forward launch failed with cudaError {err}")
    viterbi_forward.launches += 1
    return dec, final


def viterbi_traceback_cuda(dec: torch.Tensor, constraint: int, polys,
                           start_state: torch.Tensor | None = None) -> torch.Tensor:
    """Hopper kernel: decisions (T, G, L) int32 on a CUDA device -> bits (T, L) int32.

    `start_state` is an (L,) tensor of states in [0, S) on the same device,
    or None for state 0 in every lane.
    """
    polys = tuple(polys)
    _check_code(constraint, polys)
    _check_cuda("viterbi_traceback_cuda", dec, SYMBOL_DTYPE)
    steps, groups, lanes = dec.shape
    if groups != (1 << (constraint - 1)) // word_width(constraint):
        raise ValueError(f"decisions have {groups} words per step, K={constraint} needs "
                         f"{(1 << (constraint - 1)) // word_width(constraint)}")
    start_ptr = None
    if start_state is not None:
        start_state = start_state.to(SYMBOL_DTYPE).contiguous()
        if start_state.device != dec.device or tuple(start_state.shape) != (lanes,):
            raise ValueError(f"start_state must be ({lanes},) on {dec.device}, got "
                             f"{tuple(start_state.shape)} on {start_state.device}")
        start_ptr = start_state.data_ptr()
    bits = torch.empty((steps, lanes), dtype=SYMBOL_DTYPE, device=dec.device)
    if lanes == 0 or steps == 0:
        return bits
    plan = traceback_plan(constraint, lanes)
    with torch.cuda.device(dec.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()[1](dec.data_ptr(), start_ptr, bits.data_ptr(), steps, lanes,
                            constraint, plan.chunk, plan.blocks, stream)
    if err != 0:
        raise RuntimeError(f"r4w_viterbi_traceback launch failed with cudaError {err}")
    viterbi_traceback.launches += 1
    return bits


def viterbi_forward_dispatch(bm: torch.Tensor, constraint: int, polys):
    """(T, C, L) branch metrics -> (decisions, final metrics), by bm's device.

    CPU: the plain version. CUDA: the Hopper kernel. Any other device raises.
    """
    if bm.device.type == "cpu":
        return viterbi_forward(bm, constraint, polys)
    if bm.device.type != "cuda":
        raise ValueError(f"no viterbi_forward path for device {bm.device}")
    return viterbi_forward_cuda(bm.contiguous(), constraint, polys)


def viterbi_traceback_dispatch(dec: torch.Tensor, constraint: int, polys,
                               start_state: torch.Tensor | None = None) -> torch.Tensor:
    """(T, G, L) decisions -> (T, L) bits, by the decisions' device, as above."""
    if dec.device.type == "cpu":
        return viterbi_traceback(dec, constraint, polys, start_state)
    if dec.device.type != "cuda":
        raise ValueError(f"no viterbi_traceback path for device {dec.device}")
    return viterbi_traceback_cuda(dec.contiguous(), constraint, polys, start_state)
