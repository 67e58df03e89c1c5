"""Digital down-conversion and the voltage-controlled oscillator.

PyTorch counterpart of two blocks of ``r4w_tpu.ops.stream_math``
(digital_down_converter.rs, vco.rs); the rest of that module is not ported
yet. The down-converter's mix runs through `kernels.nco.nco_mix_dispatch`
and its lowpass through `filters.decimating_fir`, so on a CUDA tensor the
path is two Hopper kernels (the FIR reads a zero state without allocating
one) and a copy of the new state's K-1 samples.
"""

from __future__ import annotations

import math

import torch

from r4w_tpu_torch.core.hostio import cis
from r4w_tpu_torch.core.types import IQ_DTYPE, REAL_DTYPE, to_tensor
from r4w_tpu_torch.kernels.nco import nco_mix_dispatch
from r4w_tpu_torch.ops.filters import decimating_fir, design_lowpass


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
