"""Stream math and conversion blocks, the digital down-converter and the VCO.

PyTorch counterpart of ``r4w_tpu.ops.stream_math`` (complex_to_mag_phase.rs,
complex_to_arg.rs, complex_normalize.rs, conjugate.rs, abs_blk.rs,
add_blk.rs, multiply.rs, argmax.rs, bin_statistics.rs, threshold.rs,
signal_clipper.rs, binary_slicer.rs, char_to_float.rs, bit_packing.rs,
complex_to_interleaved.rs, uniform_scalar_quantizer.rs,
sigma_delta_modulator.rs, companding_codec.rs, adpcm_codec.rs, vco.rs,
digital_down_converter.rs, burst_shaper.rs). Samples are on the last axis,
leading axes a batch.

The down-converter's mix runs through `kernels.nco.nco_mix_dispatch` and
its lowpass through `filters.decimating_fir`, so on a CUDA tensor the path
is two Hopper kernels (the FIR reads a zero state without allocating one)
and a copy of the new state's K-1 samples. `threshold_block` is the
hysteresis comparator in its parallel form (`events.latest_set`: the last
decisive sample wins), equal to the reference's scan. The ΣΔ modulator and
the IMA ADPCM codec stay step loops over the samples, as the reference's
``lax.scan``s are, their state a tensor on the samples' device; |x| of
complex64 is the reference's compiled formula (`core.hostio.complex_abs`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from r4w_tpu_torch.core.hostio import cis, complex_abs, magnitude
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, real_scalar, to_tensor
from r4w_tpu_torch.kernels.nco import nco_mix_dispatch
from r4w_tpu_torch.ops.events import latest_set
from r4w_tpu_torch.ops.filters import decimating_fir, design_lowpass

# ------------------------------------------------------- conversions


def complex_to_mag_phase(x):
    x = to_tensor(x, IQ_DTYPE)
    return complex_abs(x), torch.angle(x)


def mag_phase_to_complex(mag, phase):
    mag = to_tensor(mag, REAL_DTYPE)
    return mag * cis(to_tensor(phase, REAL_DTYPE, device=mag.device))


def complex_to_arg(x):
    return torch.angle(to_tensor(x, IQ_DTYPE))


def complex_normalize(x, epsilon: float = 1e-12):
    x = to_tensor(x, IQ_DTYPE)
    return x / torch.clamp(complex_abs(x), min=epsilon)


def complex_to_interleaved(x) -> torch.Tensor:
    """(..., N) complex -> (..., 2N) interleaved re/im float32."""
    x = to_tensor(x, IQ_DTYPE)
    return torch.view_as_real(x).reshape(*x.shape[:-1], -1)


def interleaved_to_complex(x) -> torch.Tensor:
    x = to_tensor(x, REAL_DTYPE)
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    return torch.complex(pairs[..., 0], pairs[..., 1])


def char_to_float(x, scale: float = 128.0):
    x = to_tensor(x, torch.int32).to(REAL_DTYPE)
    return x / real_scalar(scale, x.device)


def float_to_char(x, scale: float = 128.0):
    return torch.clamp(torch.round(to_tensor(x, REAL_DTYPE) * scale), -128, 127).to(torch.int32)


# -------------------------------------------------------- arithmetic


def stream_add(*xs):
    out = to_tensor(xs[0])
    for x in xs[1:]:
        out = out + to_tensor(x, device=out.device)
    return out


def stream_multiply(*xs):
    out = to_tensor(xs[0])
    for x in xs[1:]:
        out = out * to_tensor(x, device=out.device)
    return out


def stream_abs(x):
    return magnitude(x)


def stream_conjugate(x):
    return torch.conj(to_tensor(x, IQ_DTYPE)).resolve_conj()


def argmax_block(x, axis: int = -1):
    """(index int32, value) of the max along `axis` (argmax.rs); the first
    index of a tie, as the reference's."""
    x = to_tensor(x)
    value, idx = torch.max(x, dim=axis)
    return idx.to(torch.int32), value


def bin_statistics(x, n_bins: int):
    """Per-bin min/max/mean over equal chunks (bin_statistics.rs)."""
    x = to_tensor(x, REAL_DTYPE)
    m = x.shape[-1] // n_bins
    b = x[..., : m * n_bins].reshape(*x.shape[:-1], n_bins, m)
    return torch.amin(b, -1), torch.amax(b, -1), torch.mean(b, -1)


def threshold_block(x, lo: float, hi: float | None = None):
    """Hysteresis comparator (threshold.rs): 1 at or above hi, 0 at or below
    lo, the previous output in between, from 0. hi defaults to lo."""
    x = to_tensor(x, REAL_DTYPE)
    hi = lo if hi is None else hi
    on = x >= float(np.float32(hi))
    state, _ = latest_set(on | (x <= float(np.float32(lo))), on.to(REAL_DTYPE))
    return state


def signal_clipper(x, limit: float):
    """Hard amplitude clip; complex keeps its phase (signal_clipper.rs)."""
    x = to_tensor(x)
    if x.is_complex():
        limit_t = real_scalar(limit, x.device)
        scale = torch.clamp(limit_t / torch.clamp(complex_abs(x), min=1e-12), max=1.0)
        return x * scale
    return torch.clamp(x, -limit, limit)


def binary_slicer(x):
    """sign -> bits (binary_slicer.rs): x >= 0 -> 1 else 0."""
    x = to_tensor(x)
    return ((x.real if x.is_complex() else x) >= 0).to(torch.int32)


# ------------------------------------------------------ bit packing


def pack_bits(bits, bits_per_word: int = 8, msb_first: bool = True):
    """(..., N) bits -> (..., N/k) int32 words (bit_packing.rs,
    unpacked_to_packed.rs)."""
    b = to_tensor(bits, torch.int32)
    n = b.shape[-1] // bits_per_word
    grp = b[..., : n * bits_per_word].reshape(*b.shape[:-1], n, bits_per_word)
    shifts = torch.arange(bits_per_word, dtype=torch.int32, device=b.device)
    if msb_first:
        shifts = shifts.flip(0)
    return torch.sum(grp << shifts, dim=-1, dtype=torch.int32)


def unpack_bits(words, bits_per_word: int = 8, msb_first: bool = True):
    w = to_tensor(words, torch.int32)
    shifts = torch.arange(bits_per_word, dtype=torch.int32, device=w.device)
    if msb_first:
        shifts = shifts.flip(0)
    return ((w[..., None] >> shifts) & 1).reshape(*w.shape[:-1], -1)


# ------------------------------------------------------ quantization


def uniform_quantize(x, n_bits: int, full_scale: float = 1.0):
    """Mid-rise uniform quantizer -> (levels int32, reconstructed)
    (uniform_scalar_quantizer.rs)."""
    x = to_tensor(x, REAL_DTYPE)
    n_levels = 1 << n_bits
    step = 2.0 * full_scale / n_levels
    idx = torch.clamp(torch.floor((x + full_scale) / real_scalar(step, x.device)), 0,
                      n_levels - 1)
    recon = (idx + 0.5) * float(np.float32(step)) - float(np.float32(full_scale))
    return idx.to(torch.int32), recon


def sigma_delta_modulate(x):
    """First-order ΣΔ: a 1-bit stream whose running mean tracks x
    (sigma_delta_modulator.rs). A step loop over the samples."""
    x = to_tensor(x, REAL_DTYPE)
    integ = x.new_zeros(x.shape[:-1])
    one = torch.ones_like(integ)
    bits = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for t in range(x.shape[-1]):
        y = torch.where(integ >= 0, one, -one)
        integ = integ + x[..., t] - y
        bits[..., t] = (y > 0).to(torch.int32)
    return bits


def mu_law_encode(x, mu: float = 255.0):
    """µ-law compression to [-1, 1] (companding_codec.rs)."""
    x = to_tensor(x, REAL_DTYPE)
    return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / real_scalar(math.log1p(mu), x.device)


def mu_law_decode(y, mu: float = 255.0):
    y = to_tensor(y, REAL_DTYPE)
    grow = torch.pow(real_scalar(1.0 + mu, y.device), torch.abs(y)) - 1.0
    return torch.sign(y) * grow / real_scalar(mu, y.device)


_IMA_STEP = np.asarray([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
    37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143,
    157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494,
    544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552,
    1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428,
    4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487,
    12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086,
    29794, 32767], np.int32)
_IMA_INDEX = np.asarray([-1, -1, -1, -1, 2, 4, 6, 8], np.int32)


def _adpcm_delta(step: torch.Tensor, nib: torch.Tensor) -> torch.Tensor:
    """Reconstruction delta for a nibble at a given step (shared by encode
    and decode; int32)."""
    return ((step >> 3) + (nib & 1) * (step >> 2) + ((nib >> 1) & 1) * (step >> 1)
            + ((nib >> 2) & 1) * step)


def _adpcm_next(pred, idx, step, nib, steps_tab, index_tab):
    """(predictor, index) after one nibble."""
    delta = _adpcm_delta(step, nib)
    pred = torch.clamp(pred + torch.where((nib & 8) != 0, -delta, delta), -32768, 32767)
    idx = torch.clamp(idx + index_tab[nib & 7], 0, 88)
    return pred, idx


def adpcm_encode(pcm16) -> tuple[torch.Tensor, tuple]:
    """IMA ADPCM 4-bit encode (adpcm_codec.rs) of a 1-D int stream, a step
    loop over the (predictor, index) state. Returns (nibbles int32, final
    state)."""
    x = to_tensor(pcm16, torch.int32)
    steps_tab = torch.from_numpy(_IMA_STEP).to(x.device)
    index_tab = torch.from_numpy(_IMA_INDEX).to(x.device)
    pred = torch.zeros((), dtype=torch.int32, device=x.device)
    idx = torch.zeros_like(pred)
    out = torch.empty_like(x)
    for t in range(x.shape[0]):
        step = steps_tab[idx]
        diff = x[t] - pred
        sign = (diff < 0).to(torch.int32) * 8
        diff = torch.abs(diff)
        b4 = (diff >= step).to(torch.int32)
        diff = diff - b4 * step
        b2 = (diff >= (step >> 1)).to(torch.int32)
        diff = diff - b2 * (step >> 1)
        b1 = (diff >= (step >> 2)).to(torch.int32)
        nib = sign | (b4 << 2) | (b2 << 1) | b1
        out[t] = nib
        pred, idx = _adpcm_next(pred, idx, step, nib, steps_tab, index_tab)
    return out, (pred, idx)


def adpcm_decode(nibbles, state: tuple = (0, 0)) -> torch.Tensor:
    nib_all = to_tensor(nibbles, torch.int32)
    steps_tab = torch.from_numpy(_IMA_STEP).to(nib_all.device)
    index_tab = torch.from_numpy(_IMA_INDEX).to(nib_all.device)
    pred = torch.as_tensor(state[0], dtype=torch.int32, device=nib_all.device)
    idx = torch.as_tensor(state[1], dtype=torch.int32, device=nib_all.device)
    out = torch.empty_like(nib_all)
    for t in range(nib_all.shape[0]):
        pred, idx = _adpcm_next(pred, idx, steps_tab[idx], nib_all[t], steps_tab, index_tab)
        out[t] = pred
    return out


# ------------------------------------------------------------- NCOs


def vco(control, sensitivity_hz_per_unit: float, sample_rate: float,
        phase0: float = 0.0):
    """Voltage-controlled oscillator: phase integral of the control
    signal (vco.rs), a cumsum along the last axis."""
    c = to_tensor(control, REAL_DTYPE)
    dphi = 2.0 * math.pi * sensitivity_hz_per_unit * c / sample_rate
    phase = phase0 + torch.cumsum(dphi, dim=-1)
    return cis(phase)


def digital_down_convert(x, center_hz: float, sample_rate: float,
                         decimation: int, taps=None):
    """DDC: mix `center_hz` to baseband, lowpass and decimate
    (digital_down_converter.rs). Default taps:
    ``design_lowpass(63, sample_rate / (2.5·decimation), sample_rate)``."""
    x = to_tensor(x, IQ_DTYPE)
    if taps is None:
        taps = design_lowpass(63, sample_rate / (2.5 * decimation), sample_rate)
    # before the mix: a copy from pageable host memory waits for the stream,
    # which would hold the FIR's launch until the mix is done
    taps = to_tensor(taps, REAL_DTYPE, device=x.device)
    base = nco_mix_dispatch(x, -center_hz, sample_rate)
    y, _ = decimating_fir(taps, base, decimation)
    return y


def burst_shape(x, ramp: int = 32, window: str = "hann"):
    """Raised-cosine amplitude ramps on a burst's edges (burst_shaper.rs):
    `ramp` samples of attack and decay, the middle untouched."""
    x = to_tensor(x)
    n = x.shape[-1]
    if 2 * ramp >= n:
        ramp = max(n // 2 - 1, 1)
    t = torch.arange(ramp, dtype=REAL_DTYPE, device=x.device) / real_scalar(ramp, x.device)
    up = 0.5 * (1.0 - torch.cos(math.pi * t))
    env = torch.cat([up, torch.ones(n - 2 * ramp, dtype=REAL_DTYPE, device=x.device),
                     up.flip(0)])
    return x * env
