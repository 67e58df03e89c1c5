"""Polyphase resampling.

PyTorch counterpart of the polyphase part of ``r4w_tpu.ops.resample``
(filters/polyphase.rs: PolyphaseDecimator:52, PolyphaseInterpolator:281,
Resampler:471, HalfbandFilter:657). Decimation goes through
`filters.decimating_fir`, so only the kept outputs are computed (the
reference filters at the full rate and then drops samples; the results
are the same). Interpolation zero-stuffs and filters, as the reference
does. The arbitrary-ratio, Farrow and PFB resamplers and the PFB clock
sync are not ported yet.
"""

from __future__ import annotations

import numpy as np

from r4w_tpu_torch.ops.filters import (_signal, _zero_stuff, decimating_fir, design_lowpass,
                                       interpolating_fir)


def polyphase_decompose(taps: np.ndarray, phases: int) -> np.ndarray:
    """(K,) prototype -> (phases, ceil(K/phases)) polyphase bank."""
    k = len(taps)
    pad = (-k) % phases
    t = np.pad(np.asarray(taps), (0, pad))
    return t.reshape(-1, phases).T.copy()  # (phases, taps_per_phase)


def polyphase_decimate(x, taps, factor: int):
    """Decimating FIR: filter and downsample in one pass (polyphase.rs:52).
    Output rate = input/factor."""
    y, _ = decimating_fir(taps, x, factor)
    return y


def polyphase_interpolate(x, taps, factor: int):
    """Interpolating FIR (polyphase.rs:281). Gain-compensated."""
    return interpolating_fir(taps, x, factor)


def rational_resample(x, up: int, down: int, num_taps: int = 128):
    """Rational L/M resampler (polyphase.rs:471 Resampler): zero-stuff by
    L, then a decimating FIR by M that computes only the kept outputs."""
    taps = design_lowpass(num_taps, 0.5 / max(up, down), 1.0)
    y, _ = decimating_fir(taps, _zero_stuff(_signal(x), up), down)
    return y


def halfband_taps(num_taps: int = 31) -> np.ndarray:
    """Halfband lowpass: every other tap zero (polyphase.rs:657)."""
    if num_taps % 2 != 1:
        raise ValueError(f"halfband_taps needs an odd tap count, got {num_taps}")
    t = design_lowpass(num_taps, 0.25, 1.0, window="hamming")
    mid = num_taps // 2
    idx = np.arange(num_taps)
    t = np.where((idx != mid) & ((idx - mid) % 2 == 0), 0.0, t)
    return (t / t.sum()).astype(np.float32)


def halfband_decimate(x, num_taps: int = 31):
    return polyphase_decimate(x, halfband_taps(num_taps), 2)
